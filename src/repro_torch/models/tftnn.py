"""TFTNN (the paper's model): config, parameters, forward passes.

Counterpart of ``repro/models/tftnn.py`` for the TFTNN corner of the family
(BN, ReLU, residual-split dilated blocks, softmax-free sub-band attention,
gateless mask module), inference only. The parameter tree has the
reference's exact layout, so trees convert leaf by leaf in both directions.

- ``apply_tft``: the training graph over a whole spectrogram (B, F, T, 2),
  the forward pass of ``serve.streaming_se.enhance_offline``;
- ``stream_step``: the same graph one frame at a time, carrying the
  full-band GRU state (the reference's ``"xla"`` hop);
- the deployed, BN-folded forward pass lives in ``repro_torch.serve.deploy``.

Features are (B, F, T, C), as in the reference. Convolutions stay
``torch.nn.functional.conv2d`` (the reference leaves them to XLA); the
sub-band attention runs on the non-causal CUDA kernel on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.core.bn import BatchNorm
from repro_torch.core.bn_transformer import (
    BNTransformerConfig,
    apply_bn_transformer,
    init_bn_transformer,
    streaming_gru_substep,
)

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


# ---------------------------------------------------------------------------
# Forward pass (inference): norm, activation, convolutions, blocks
# ---------------------------------------------------------------------------

def _apply_norm(cfg: TFTConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm != "bn":
        raise NotImplementedError(f"norm={cfg.norm!r} is not ported yet")
    return BatchNorm(x.shape[-1])(p, x)


def _apply_act(cfg: TFTConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation != "relu":
        raise NotImplementedError(f"activation={cfg.activation!r} is not ported yet")
    return nn.relu(x)


def _conv2d(p: Params, x: torch.Tensor, *, stride_f: int = 1, dil_f: int = 1,
            causal_t: bool = True) -> torch.Tensor:
    """Conv over (F, T) of (B, F, T, C) with SAME-f and causal-t padding.

    The weight keeps the reference's (kf, kt, cin, cout) layout and is
    transposed to PyTorch's (cout, cin, kf, kt) here.
    """
    w = p["w"]
    kf, kt = w.shape[0], w.shape[1]
    pad_f = (kf - 1) * dil_f // 2
    pad_t = (kt - 1, 0) if causal_t else ((kt - 1) // 2, kt // 2)
    xt = F.pad(x.permute(0, 3, 1, 2), (*pad_t, pad_f, (kf - 1) * dil_f - pad_f))
    y = F.conv2d(xt, w.permute(3, 2, 0, 1), p["b"], stride=(stride_f, 1), dilation=(dil_f, 1))
    return y.permute(0, 2, 3, 1)


def _apply_dilated_block(cfg: TFTConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The residual-split dilated block (Fig. 2b): each layer convolves half
    the channels, adds them back as a residual and swaps the halves."""
    if cfg.dilated_block != "residual_split":
        raise NotImplementedError(f"dilated_block={cfg.dilated_block!r} is not ported yet")
    out = x
    for layer, d in zip(p["layers"], cfg.dilation_rates):
        C = out.shape[-1]
        xp, xb = out[..., : C // 2], out[..., C // 2 :]
        y = _conv2d(layer["conv"], xp, dil_f=d, causal_t=True)
        y = _apply_act(cfg, _apply_norm(cfg, layer["norm"], y)) + xp  # residual
        out = torch.cat([xb, y], dim=-1)
    return out


def _apply_stage(cfg: TFTConfig, p: Params, x: torch.Tensor, tcfg: BNTransformerConfig,
                 gru: Optional[torch.nn.GRU] = None) -> torch.Tensor:
    """One transformer stage on (N, L, d) (the BN path)."""
    if cfg.norm != "bn":
        raise NotImplementedError(f"norm={cfg.norm!r} is not ported yet")
    return apply_bn_transformer(p, x, tcfg, gru=gru)[0]


def sub_band_grus(p: Params) -> Tuple[torch.nn.GRU, ...]:
    """One ``torch.nn.GRU`` per block holding its sub-band bi-GRU, on the
    weights' device: built once per parameter tree, used on every frame."""
    return tuple(nn.bigru_module(blk["sub"]["gru_f"], blk["sub"]["gru_b"]) for blk in p["blocks"])


def _encode(cfg: TFTConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    causal_t = cfg.conv_kernel_t == 1
    y = _conv2d(p["enc_in"], x, causal_t=causal_t)
    y = _apply_act(cfg, _apply_norm(cfg, p["enc_in_norm"], y))
    y = _apply_dilated_block(cfg, p["enc_dilated"], y)
    y = _conv2d(p["enc_down"], y, stride_f=cfg.downsample, causal_t=causal_t)
    return _apply_act(cfg, _apply_norm(cfg, p["enc_down_norm"], y))


def _transform(cfg: TFTConfig, p: Params, y: torch.Tensor,
               sub_grus: Sequence[torch.nn.GRU]) -> torch.Tensor:
    """Two-stage transformer trunk on (B, F', T, C)."""
    B, Fp, T, _ = y.shape
    d = cfg.att_dim
    z = nn.dense(p["att_in"], y)  # (B, F', T, d)
    for blk, gru in zip(p["blocks"], sub_grus):
        # sub-band stage: sequence along F' for each time frame
        zs = z.transpose(1, 2).reshape(B * T, Fp, d)
        zs = _apply_stage(cfg, blk["sub"], zs, _sub_cfg(cfg), gru)
        z = zs.reshape(B, T, Fp, d).transpose(1, 2)
        # full-band stage: sequence along T for each frequency
        zf = _apply_stage(cfg, blk["full"], z.reshape(B * Fp, T, d), _full_cfg(cfg))
        z = zf.reshape(B, Fp, T, d)
    return nn.dense(p["att_out"], z)  # (B, F', T, C)


def _mask_and_decode(cfg: TFTConfig, p: Params, enc: torch.Tensor, tr: torch.Tensor) -> torch.Tensor:
    if cfg.mask_gtu:
        raise NotImplementedError("the GTU mask module is not ported yet")
    m = _apply_act(cfg, _conv2d(p["mask_conv1"], tr, causal_t=True))
    m = _conv2d(p["mask_conv2"], m, causal_t=True)
    h = _apply_dilated_block(cfg, p["dec_dilated"], enc * m)
    h = _conv2d(p["dec_up"], h, causal_t=cfg.conv_kernel_t == 1)
    h = _apply_act(cfg, _apply_norm(cfg, p["dec_up_norm"], h))
    # sub-pixel upsample along F: (B, F', T, C*r) -> (B, F'*r, T, C)
    B, Fp, T, Cr = h.shape
    r = cfg.downsample
    h = h.reshape(B, Fp, T, r, Cr // r).permute(0, 1, 3, 2, 4).reshape(B, Fp * r, T, Cr // r)
    return _conv2d(p["dec_out"], h, causal_t=cfg.conv_kernel_t == 1)  # (B, F, T, 2)


def apply_tft(p: Params, spec_ri: torch.Tensor, cfg: TFTConfig, *,
              train: bool = False) -> Tuple[torch.Tensor, Params]:
    """Forward pass: noisy spectrogram -> complex-ratio mask (inference).

    spec_ri: (B, F, T, 2) with F == cfg.freq_bins (+1 nyquist bin allowed,
    cropped internally and restored as zeros). Returns ``(mask_ri, p)``,
    mask_ri (B, F_in, T, 2); the parameters come back unchanged.

    Raises:
        NotImplementedError: ``train=True`` (not ported yet).
    """
    if train:
        raise NotImplementedError("apply_tft: train=True is not ported yet")
    F_in = spec_ri.shape[1]
    enc = _encode(cfg, p, spec_ri[:, : cfg.freq_bins])
    tr = _transform(cfg, p, enc, sub_band_grus(p))
    mask = _mask_and_decode(cfg, p, enc, tr)
    if F_in > cfg.freq_bins:
        mask = torch.cat([mask, torch.zeros_like(spec_ri[:, cfg.freq_bins :])], dim=1)
    return mask, p


def init_stream_state(p: Params, cfg: TFTConfig, batch: int, *, device=None,
                      dtype=torch.float32) -> Params:
    """Streaming state = the full-band GRU hidden per block, (batch, F', hidden)."""
    if not cfg.is_causal:
        raise ValueError(f"{cfg.name} is not causal; streaming unsupported")
    return {
        f"block{i}": torch.zeros((batch, cfg.att_len, cfg.gru_hidden), dtype=dtype, device=device)
        for i in range(cfg.num_transformer_blocks)
    }


def stream_step(p: Params, state: Dict[str, torch.Tensor], frame_ri: torch.Tensor,
                cfg: TFTConfig, *, sub_grus: Optional[Sequence[torch.nn.GRU]] = None
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Process one spectrogram frame. frame_ri: (B, F, 2) -> mask (B, F, 2).

    With kt=1 all convolutions are frame-local and the sub-band stage is
    frame-local; only the full-band uni-directional GRU carries state.
    ``sub_grus``: ``sub_band_grus(p)``, built once by a caller that steps
    many frames; built here when None.
    """
    B = frame_ri.shape[0]
    enc = _encode(cfg, p, frame_ri[:, : cfg.freq_bins, None, :])  # (B, F', 1, C)
    Fp = enc.shape[1]
    z = nn.dense(p["att_in"], enc[:, :, 0, :])  # (B, F', d)
    new_state = dict(state)
    for i, (blk, gru) in enumerate(zip(p["blocks"], sub_grus or sub_band_grus(p))):
        zs = _apply_stage(cfg, blk["sub"], z, _sub_cfg(cfg), gru)
        h0 = state[f"block{i}"].reshape(B * Fp, cfg.gru_hidden)
        h, z_out = streaming_gru_substep(blk["full"], _full_cfg(cfg), h0, zs.reshape(B * Fp, cfg.att_dim))
        new_state[f"block{i}"] = h.reshape(B, Fp, cfg.gru_hidden)
        z = z_out.reshape(B, Fp, cfg.att_dim)
    tr = nn.dense(p["att_out"], z)[:, :, None, :]
    mask = _mask_and_decode(cfg, p, enc, tr)[:, :, 0, :]  # (B, F, 2)
    if frame_ri.shape[1] > cfg.freq_bins:
        mask = torch.cat([mask, torch.zeros_like(frame_ri[:, cfg.freq_bins :])], dim=1)
    return new_state, mask


def param_count(p: Any) -> int:
    """Number of scalars in a parameter tree."""
    if isinstance(p, dict):
        return sum(param_count(v) for v in p.values())
    if isinstance(p, (list, tuple)):
        return sum(param_count(v) for v in p)
    return int(p.numel())
