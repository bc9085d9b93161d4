"""TFTNN (the paper's model): config, parameter init, streaming state.

Counterpart of ``repro/models/tftnn.py`` for what the deployed hop needs.
The parameter tree has the reference's exact layout (so trees convert
leaf by leaf in both directions); the training-graph forward pass
(``apply_tft``/``stream_step``) is not ported yet; the deployed forward
pass lives in ``repro_torch.serve.deploy``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import nn
from repro_torch.core.bn import BatchNorm
from repro_torch.core.bn_transformer import BNTransformerConfig, init_bn_transformer

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TFTConfig:
    """The TSTNN->TFTNN family. Defaults = TFTNN (the paper's final model)."""

    name: str = "tftnn"
    n_fft: int = 512
    hop: int = 128
    freq_bins: int = 256  # 257 rfft bins, nyquist dropped for a pow-2 axis
    channels: int = 32
    att_dim: int = 16  # head_dim = 8 (Eq. 1)
    num_heads: int = 2
    gru_hidden: int = 32
    num_transformer_blocks: int = 2
    dilation_rates: Tuple[int, ...] = (1, 2, 4, 8)
    dilated_block: str = "residual_split"  # | "dense"
    conv_kernel_t: int = 1
    conv_kernel_f: int = 5
    downsample: int = 2
    norm: str = "bn"  # | "ln"
    activation: str = "relu"  # | "prelu"
    softmax_free: bool = True
    extra_bn: bool = True
    full_band_attention: bool = False
    bidirectional_fullband_gru: bool = False
    mask_gtu: bool = False
    mask_domain: str = "tf"

    @property
    def att_len(self) -> int:
        """Sub-band attention length h (Eq. 1: h = 128)."""
        return self.freq_bins // self.downsample

    @property
    def is_causal(self) -> bool:
        return (
            self.conv_kernel_t == 1
            and not self.full_band_attention
            and not self.bidirectional_fullband_gru
        )


def tstnn_config() -> TFTConfig:
    """The TSTNN-family baseline (not deployable; used to test validation)."""
    return TFTConfig(
        name="tstnn", channels=64, att_dim=32, num_heads=4, gru_hidden=64,
        num_transformer_blocks=4, dilated_block="dense", conv_kernel_t=2,
        conv_kernel_f=3, norm="ln", activation="prelu", softmax_free=False,
        extra_bn=False, full_band_attention=True,
        bidirectional_fullband_gru=True, mask_gtu=True, mask_domain="tf",
    )


def tftnn_config() -> TFTConfig:
    return TFTConfig()


def _sub_cfg(cfg: TFTConfig) -> BNTransformerConfig:
    return BNTransformerConfig(
        d_model=cfg.att_dim, num_heads=cfg.num_heads, gru_hidden=cfg.gru_hidden,
        use_attention=True, bidirectional_gru=True,
        softmax_free=cfg.softmax_free,
    )


def _full_cfg(cfg: TFTConfig) -> BNTransformerConfig:
    return BNTransformerConfig(
        d_model=cfg.att_dim, num_heads=cfg.num_heads, gru_hidden=cfg.gru_hidden,
        use_attention=cfg.full_band_attention,
        bidirectional_gru=cfg.bidirectional_fullband_gru,
        softmax_free=cfg.softmax_free,
    )


def _init_conv2d(gen: torch.Generator, kf: int, kt: int, cin: int, cout: int, dtype) -> Params:
    bound = 1.0 / math.sqrt(kf * kt * cin)
    return {
        "w": torch.empty((kf, kt, cin, cout), dtype=dtype).uniform_(-bound, bound, generator=gen),
        "b": torch.empty((cout,), dtype=dtype).uniform_(-bound, bound, generator=gen),
    }


def _init_dilated_block(cfg: TFTConfig, gen: torch.Generator, dtype) -> Params:
    """residual_split layers: each processes half the channels, bypasses half."""
    half = cfg.channels // 2
    return {"layers": [
        {"conv": _init_conv2d(gen, cfg.conv_kernel_f, cfg.conv_kernel_t, half, half, dtype),
         "norm": BatchNorm(half).init(dtype), "act": {}}
        for _ in cfg.dilation_rates
    ]}


def init_tft(gen: torch.Generator, cfg: TFTConfig, dtype=torch.float32) -> Params:
    """Parameter tree with the reference ``init_tft`` layout (CPU tensors).

    Uniform fan-in init drawn from ``gen``; pass
    ``torch.Generator().manual_seed(seed)`` for a reproducible tree. Only
    the TFTNN corner of the family is ported (BN, ReLU, residual-split
    dilated blocks, gateless mask module).

    Raises:
        NotImplementedError: ``cfg`` is outside the TFTNN corner.
    """
    if (cfg.norm, cfg.activation, cfg.dilated_block, cfg.mask_gtu) != ("bn", "relu", "residual_split", False):
        raise NotImplementedError(f"init_tft: config {cfg.name!r} is outside the ported TFTNN corner")
    C, d = cfg.channels, cfg.att_dim
    kf, kt = cfg.conv_kernel_f, cfg.conv_kernel_t
    p: Params = {}
    p["enc_in"] = _init_conv2d(gen, kf, kt, 2, C, dtype)
    p["enc_in_norm"] = BatchNorm(C).init(dtype)
    p["enc_in_act"] = {}
    p["enc_dilated"] = _init_dilated_block(cfg, gen, dtype)
    p["enc_down"] = _init_conv2d(gen, kf, kt, C, C, dtype)
    p["enc_down_norm"] = BatchNorm(C).init(dtype)
    p["enc_down_act"] = {}
    p["att_in"] = nn.init_dense(gen, C, d, dtype=dtype)
    p["att_out"] = nn.init_dense(gen, d, C, dtype=dtype)
    p["blocks"] = [
        {"sub": init_bn_transformer(gen, _sub_cfg(cfg), dtype),
         "full": init_bn_transformer(gen, _full_cfg(cfg), dtype)}
        for _ in range(cfg.num_transformer_blocks)
    ]
    p["mask_conv1"] = _init_conv2d(gen, 1, 1, C, C, dtype)
    p["mask_act"] = {}
    p["mask_conv2"] = _init_conv2d(gen, 1, 1, C, C, dtype)
    p["dec_dilated"] = _init_dilated_block(cfg, gen, dtype)
    p["dec_up"] = _init_conv2d(gen, kf, kt, C, C * cfg.downsample, dtype)
    p["dec_up_norm"] = BatchNorm(C * cfg.downsample).init(dtype)
    p["dec_up_act"] = {}
    p["dec_out"] = _init_conv2d(gen, kf, kt, C, 2, dtype)
    return p


def init_stream_state(p: Params, cfg: TFTConfig, batch: int, *, device=None,
                      dtype=torch.float32) -> Params:
    """Streaming state = the full-band GRU hidden per block, (batch, F', hidden)."""
    if not cfg.is_causal:
        raise ValueError(f"{cfg.name} is not causal; streaming unsupported")
    return {
        f"block{i}": torch.zeros((batch, cfg.att_len, cfg.gru_hidden), dtype=dtype, device=device)
        for i in range(cfg.num_transformer_blocks)
    }


def param_count(p: Any) -> int:
    """Number of scalars in a parameter tree."""
    if isinstance(p, dict):
        return sum(param_count(v) for v in p.values())
    if isinstance(p, (list, tuple)):
        return sum(param_count(v) for v in p)
    return int(p.numel())
