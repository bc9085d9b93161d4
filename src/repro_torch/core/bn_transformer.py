"""The BN-based transformer block (Fig. 7) with softmax-free MHA (Fig. 8b).

Counterpart of ``repro/core/bn_transformer.py``, inference only::

    y = x + MHA_sf(BN1(x))            # attention sub-block (optional)
    z = y + W_out . GRU(BN2(y))       # GRU sub-block

MHA_sf projects Q, K, V, applies the extra BN on Q and K, and computes
attention softmax-free as Q @ (K^T V) / L (``core.softmax_free_attention``,
on the card the non-causal CUDA kernel). A bidirectional block's GRU runs as
one ``torch.nn.GRU`` (``nn.bigru_module``). The deployed hop runs the same
block folded inside ``repro_torch.serve.deploy`` (``fold_qk_bn`` here).
The softmax branch (the TSTNN baseline), causal attention and train mode
are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import nn
from repro_torch.core.bn import BatchNorm, fold_bn_into_linear
from repro_torch.core.softmax_free_attention import softmax_free_attention

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BNTransformerConfig:
    d_model: int
    num_heads: int
    gru_hidden: int
    use_attention: bool = True  # False => full-band stage after streaming prune
    causal: bool = False
    bidirectional_gru: bool = False
    softmax_free: bool = True
    qkv_bias: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def init_bn_transformer(gen: torch.Generator, cfg: BNTransformerConfig,
                        dtype=torch.float32) -> Params:
    d = cfg.d_model
    p: Params = {}
    if cfg.use_attention:
        p["bn1"] = BatchNorm(d).init(dtype)
        for name in ("wq", "wk", "wv"):
            p[name] = nn.init_dense(gen, d, d, bias=cfg.qkv_bias, dtype=dtype)
        p["wo"] = nn.init_dense(gen, d, d, dtype=dtype)
        if cfg.softmax_free:
            p["bn_q"] = BatchNorm(d).init(dtype)
            p["bn_k"] = BatchNorm(d).init(dtype)
    p["bn2"] = BatchNorm(d).init(dtype)
    p["gru_f"] = nn.init_gru(gen, d, cfg.gru_hidden, dtype)
    if cfg.bidirectional_gru:
        p["gru_b"] = nn.init_gru(gen, d, cfg.gru_hidden, dtype)
        p["w_out"] = nn.init_dense(gen, 2 * cfg.gru_hidden, d, dtype=dtype)
    else:
        p["w_out"] = nn.init_dense(gen, cfg.gru_hidden, d, dtype=dtype)
    return p


def _split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    B, L, D = x.shape
    return x.reshape(B, L, h, D // h).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, L, Dh = x.shape
    return x.transpose(1, 2).reshape(B, L, H * Dh)


def mha_softmax_free(p: Params, x: torch.Tensor, cfg: BNTransformerConfig, *,
                     train: bool = False) -> Tuple[torch.Tensor, Params]:
    """Softmax-free MHA with extra BN on Q/K. x: (B, L, D) -> ``(out, p)``.

    Raises:
        NotImplementedError: softmax attention, causal attention or train
            mode (not ported yet).
    """
    if not cfg.softmax_free:
        raise NotImplementedError("mha_softmax_free: the softmax branch is not ported yet")
    if cfg.causal:
        raise NotImplementedError("mha_softmax_free: causal attention is not ported yet")
    bn = BatchNorm(cfg.d_model)
    q, _ = bn.apply(p["bn_q"], nn.dense(p["wq"], x), train=train)
    k, _ = bn.apply(p["bn_k"], nn.dense(p["wk"], x), train=train)
    v = nn.dense(p["wv"], x)
    oh = softmax_free_attention(*(_split_heads(t, cfg.num_heads).contiguous() for t in (q, k, v)))
    return nn.dense(p["wo"], _merge_heads(oh)), p


def apply_bn_transformer(p: Params, x: torch.Tensor, cfg: BNTransformerConfig, *,
                         train: bool = False, gru: Optional[torch.nn.GRU] = None
                         ) -> Tuple[torch.Tensor, Params]:
    """Full block forward. x: (B, L, D) -> ``(z, p)``, z of x's shape.

    ``gru``: for a bidirectional block, its ``gru_f``/``gru_b`` as one
    ``nn.bigru_module`` built once by the caller; built here when None.
    """
    bn = BatchNorm(cfg.d_model)
    y = x
    if cfg.use_attention:
        h, _ = bn.apply(p["bn1"], x, train=train)
        att, _ = mha_softmax_free(p, h, cfg, train=train)
        y = x + att
    h, _ = bn.apply(p["bn2"], y, train=train)
    if cfg.bidirectional_gru:
        if gru is None:
            gru = nn.bigru_module(p["gru_f"], p["gru_b"])
        g, _ = gru(h)
    else:
        g, _ = nn.gru(p["gru_f"], h)
    return y + nn.dense(p["w_out"], g), p


def streaming_gru_substep(p: Params, cfg: BNTransformerConfig, gru_h: torch.Tensor,
                          y_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-frame update of the (uni-directional, causal) GRU sub-block.

    y_t: (B, D), one time frame after the attention sub-block. Returns
    ``(new_gru_h, z_t)``.
    """
    h_t = BatchNorm(cfg.d_model)(p["bn2"], y_t)
    gru_h, g_t = nn.gru_step(p["gru_f"], gru_h, h_t)
    return gru_h, y_t + nn.dense(p["w_out"], g_t)


def fold_qk_bn(p: Params, cfg: BNTransformerConfig) -> Params:
    """Fold the extra Q/K BNs into W_q/W_k. Returns new params without bn_q/k."""
    if not (cfg.use_attention and cfg.softmax_free):
        return p
    new_p = dict(p)
    for proj, bnk in (("wq", "bn_q"), ("wk", "bn_k")):
        w2, b2 = fold_bn_into_linear(p[proj]["w"], p[proj].get("b"), p[bnk])
        new_p[proj] = {"w": w2, "b": b2}
        del new_p[bnk]
    return new_p
