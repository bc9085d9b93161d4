"""Functional NN primitives (counterpart of ``repro/nn.py``).

Parameters are plain dicts of tensors, as in the reference, so a JAX tree
converted with ``repro_torch.bridge.params_from_numpy`` plugs in directly.
Initializers draw from an explicit ``torch.Generator``: the numbers differ
from ``jax.random`` for the same seed, the distributions do not.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


def _fan_in_init(gen: torch.Generator, shape, fan_in: int, dtype=torch.float32) -> torch.Tensor:
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    return torch.empty(shape, dtype=dtype).uniform_(-bound, bound, generator=gen)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = True,
               dtype=torch.float32) -> Params:
    p = {"w": _fan_in_init(gen, (d_in, d_out), d_in, dtype)}
    if bias:
        p["b"] = _fan_in_init(gen, (d_out,), d_in, dtype)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def init_gru(gen: torch.Generator, d_in: int, d_hidden: int, dtype=torch.float32) -> Params:
    return {
        "wi": _fan_in_init(gen, (d_in, 3 * d_hidden), d_in, dtype),
        "wh": _fan_in_init(gen, (d_hidden, 3 * d_hidden), d_hidden, dtype),
        "bi": _fan_in_init(gen, (3 * d_hidden,), d_in, dtype),
        "bh": _fan_in_init(gen, (3 * d_hidden,), d_hidden, dtype),
    }


def gru_step(p: Params, h: torch.Tensor, x_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard GRU cell, gates r, z, n. h: (B, H), x_t: (B, D). Returns (h', h')."""
    H = h.shape[-1]
    gi = x_t @ p["wi"] + p["bi"]
    gh = h @ p["wh"] + p["bh"]
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H : 2 * H] + gh[..., H : 2 * H])
    n = torch.tanh(gi[..., 2 * H :] + r * gh[..., 2 * H :])
    h_new = (1.0 - z) * n + z * h
    return h_new, h_new


def gru(p: Params, x: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
        reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a GRU over x: (B, L, D) -> (outputs (B, L, H), final h). A plain loop."""
    B, L = x.shape[0], x.shape[1]
    H = p["wh"].shape[0]
    h = torch.zeros((B, H), dtype=x.dtype, device=x.device) if h0 is None else h0
    ys = [None] * L
    for t in (reversed(range(L)) if reverse else range(L)):
        h, ys[t] = gru_step(p, h, x[:, t])
    return torch.stack(ys, dim=1), h


def bigru(p_fwd: Params, p_bwd: Params, x: torch.Tensor) -> torch.Tensor:
    """Bi-directional GRU, concatenated features, as two plain loops."""
    yf, _ = gru(p_fwd, x)
    yb, _ = gru(p_bwd, x, reverse=True)
    return torch.cat([yf, yb], dim=-1)


def bigru_module(p_fwd: Params, p_bwd: Params) -> torch.nn.GRU:
    """``torch.nn.GRU`` holding the same weights as ``bigru(p_fwd, p_bwd, .)``.

    PyTorch's GRU has the same gate order (r, z, n) and the same
    ``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``; its weights are the
    transposes of ``wi``/``wh``. One call replaces the 2 x L sequential
    ``gru_step``s of ``bigru``. The module lives on the weights' device.
    """
    d_in, three_h = p_fwd["wi"].shape
    w = p_fwd["wi"]
    mod = torch.nn.GRU(d_in, three_h // 3, batch_first=True, bidirectional=True,
                       device=w.device, dtype=w.dtype)
    with torch.no_grad():
        for suffix, p in (("", p_fwd), ("_reverse", p_bwd)):
            getattr(mod, f"weight_ih_l0{suffix}").copy_(p["wi"].T)
            getattr(mod, f"weight_hh_l0{suffix}").copy_(p["wh"].T)
            getattr(mod, f"bias_ih_l0{suffix}").copy_(p["bi"])
            getattr(mod, f"bias_hh_l0{suffix}").copy_(p["bh"])
    mod.requires_grad_(False)
    return mod
