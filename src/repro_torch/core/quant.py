"""Emulated quantization: minifloat (FP10 = 1-5-4) and fixed point.

Counterpart of ``repro/core/quant.py``. Rounding is exactly on the grid:
every step is an exact power of two built from its exponent bits, where
the reference's ``jnp.exp2`` is inexact for some negative exponents on XLA
CPU and so lands a few values off the grid (ROADMAP C1). The two agree
everywhere else.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """A quantization grid.

    kind: 'fp'  -> 1 sign + `exp` exponent + `man` mantissa bits
          'fxp' -> 1 sign + `exp` integer + `man` fractional bits
          'none'-> identity
    """

    kind: str = "none"
    exp: int = 0
    man: int = 0

    @property
    def bits(self) -> int:
        return 0 if self.kind == "none" else 1 + self.exp + self.man

    def __str__(self) -> str:
        if self.kind == "none":
            return "fp32"
        return f"{self.kind}{self.bits}(s1,e{self.exp},m{self.man})"


FP10 = QuantSpec("fp", 5, 4)  # the paper's deployment format


def _exp2_exact(e: torch.Tensor) -> torch.Tensor:
    """2**e for integer tensors e >= -252, exact (float32, subnormals included).

    Built from IEEE exponent bits as the product of two normal powers of
    two, so no transcendental function is involved on any device.
    """
    e = e.to(torch.int32)
    e1 = e.clamp(-126, 127)
    e2 = (e - e1).clamp(-126, 127)

    def bits(n: torch.Tensor) -> torch.Tensor:
        return ((n + 127) << 23).view(torch.float32)

    return bits(e1) * bits(e2)


def quantize_minifloat(x: torch.Tensor, exp_bits: int, man_bits: int) -> torch.Tensor:
    """Round x (f32) to the nearest minifloat value (RNE), saturating.

    IEEE-like grid: bias = 2^(e-1) - 1, subnormals at the bottom, no inf/nan
    codes (saturate instead).
    """
    x = x.float()
    bias = 2 ** (exp_bits - 1) - 1
    min_exp = 1 - bias
    max_exp = 2**exp_bits - 2 - bias
    max_val = (2.0 - 2.0**-man_bits) * 2.0**max_exp
    sign = torch.sign(x)
    mag = x.abs()
    # floor(log2(mag)) exactly: frexp gives mag = m * 2**p with m in [0.5, 1)
    _, p = torch.frexp(mag)
    e = (p - 1).clamp(min_exp, max_exp)
    step = _exp2_exact(e - man_bits)
    q = torch.round(mag / step) * step  # torch.round is round-half-even
    q = torch.clamp(q, max=max_val)
    q = torch.where(mag == 0, torch.zeros_like(q), q)
    return sign * q


def quantize_fixed(x: torch.Tensor, int_bits: int, frac_bits: int) -> torch.Tensor:
    """Round x to signed fixed point with `int_bits`.`frac_bits`, saturating."""
    x = x.float()
    step = 2.0**-frac_bits
    max_val = 2.0**int_bits - step
    q = torch.round(x / step) * step
    return torch.clamp(q, -(2.0**int_bits), max_val)


def quantize(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    if spec.kind == "none":
        return x
    if spec.kind == "fp":
        return quantize_minifloat(x, spec.exp, spec.man)
    if spec.kind == "fxp":
        return quantize_fixed(x, spec.exp, spec.man)
    raise ValueError(f"unknown quant kind {spec.kind!r}")


def quantize_tree(params: Any, spec: QuantSpec) -> Any:
    """Quantize every float tensor of a nested dict/list (post-training)."""
    if isinstance(params, dict):
        return {k: quantize_tree(v, spec) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_tree(v, spec) for v in params)
    if isinstance(params, torch.Tensor) and params.is_floating_point():
        return quantize(params, spec).to(params.dtype)
    return params
