"""Minifloat (FP10 = s1/e5/m4) rounding: plain version, kernel, wrapper.

Replaces the TPU kernel ``src/repro/kernels/fp10/kernel.py``
(``_quant_kernel`` / ``fp10_quantize_pallas``) with
``csrc/fp10_quantize.cu``. Both versions round exactly on the grid: every
step is an exact power of two built from its exponent bits, where the
reference's ``jnp.exp2`` is inexact for some negative exponents on XLA CPU
and so lands a few values off the grid (ROADMAP C1). The two agree with the
reference everywhere else. On the card one call reads and writes 4 bytes
per element; at the hop's sizes the launch is the bound.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.runtime import check_launch, stream_ptr, use_plain


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


def _grid(exp_bits: int, man_bits: int):
    """(min_exp, max_exp, max_val) of the s1/e/m grid: bias 2**(e-1) - 1,
    the all-ones exponent reserved, so no inf/nan codes."""
    bias = 2 ** (exp_bits - 1) - 1
    min_exp = 1 - bias
    max_exp = 2**exp_bits - 2 - bias
    if not (2 <= exp_bits <= 8 and man_bits >= 0 and min_exp - man_bits >= -149):
        raise ValueError(
            f"minifloat e{exp_bits}m{man_bits}: need 2 <= exp_bits <= 8 and a smallest "
            f"step 2**{min_exp - man_bits} representable in float32"
        )
    return min_exp, max_exp, (2.0 - 2.0**-man_bits) * 2.0**max_exp


def fp10_quantize_ref(x: torch.Tensor, exp_bits: int = 5, man_bits: int = 4) -> torch.Tensor:
    """Plain version: round x (f32) to the nearest minifloat value (RNE).

    IEEE-like grid: bias = 2^(e-1) - 1, subnormals at the bottom, no inf/nan
    codes (+-inf saturate to +-max; NaN stays NaN).
    """
    min_exp, max_exp, max_val = _grid(exp_bits, man_bits)
    x = x.float()
    sign = torch.sign(x)
    mag = x.abs()
    # floor(log2(mag)) exactly: frexp gives mag = m * 2**p with m in [0.5, 1)
    _, p = torch.frexp(mag)
    e = (p - 1).clamp(min_exp, max_exp)
    step = _exp2_exact(e - man_bits)
    q = torch.round(mag / step) * step  # torch.round is round-half-even
    q = torch.clamp(q, max=max_val)  # propagates NaN
    q = torch.where(mag == 0, torch.zeros_like(q), q)
    return sign * q


def _lib() -> ctypes.CDLL:
    lib = _build.load("fp10_quantize")
    fn = lib.fp10_quantize_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def fp10_quantize(x: torch.Tensor, exp_bits: int = 5, man_bits: int = 4) -> torch.Tensor:
    """Round a float tensor of any shape onto the s1/e/m minifloat grid.

    Returns a new float32 tensor of x's shape. CPU tensors take
    ``fp10_quantize_ref``; CUDA tensors launch the kernel
    (``fp10_quantize.launches`` counts the launches).

    Raises:
        TypeError: x is not a floating-point tensor.
        ValueError: the grid does not fit float32, or x is on another device.
        RuntimeError: the kernel could not be built or launched.
    """
    if not x.is_floating_point():
        raise TypeError(f"fp10_quantize: expected a floating-point tensor, got {x.dtype}")
    min_exp, max_exp, max_val = _grid(exp_bits, man_bits)
    if use_plain(x):
        return fp10_quantize_ref(x, exp_bits, man_bits)
    x = x.float().contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = _lib().fp10_quantize_launch(
        x.data_ptr(), out.data_ptr(), x.numel(), min_exp, max_exp, man_bits, max_val,
        stream_ptr(x),
    )
    check_launch("fp10_quantize", rc)
    fp10_quantize.launches += 1
    return out


fp10_quantize.launches = 0
