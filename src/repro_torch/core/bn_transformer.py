"""The BN-based transformer block's parameters and Q/K BN fold.

Counterpart of ``repro/core/bn_transformer.py`` for the deploy path: the
config, the parameter layout (``init_bn_transformer``) and ``fold_qk_bn``.
The block's forward pass runs folded inside ``repro_torch.serve.deploy``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import nn
from repro_torch.core.bn import BatchNorm, fold_bn_into_linear

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BNTransformerConfig:
    d_model: int
    num_heads: int
    gru_hidden: int
    use_attention: bool = True  # False => full-band stage after streaming prune
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
