"""State-carrying linear-attention hop: plain version, kernel, wrapper.

Replaces the TPU kernel ``src/repro/kernels/linear_attention/kernel.py``
(``_step_kernel`` / ``linear_attention_step_pallas``) with
``csrc/linear_attention.cu``. On the card the call is bound by its launch,
not by bytes or FLOPs (see the source's header). The non-causal and causal
Pallas kernels of the same file are not on the deployed hop and are not
ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.runtime import check_f32_contiguous, check_launch, stream_ptr, use_plain


def linear_attention_step_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version (mirrors ``repro/kernels/linear_attention/ref.py``).

    new_kv = kv + K^T V; out = Q @ new_kv (unnormalized).
    """
    new_kv = kv.float() + torch.einsum("bhld,bhle->bhde", k.float(), v.float())
    out = torch.einsum("bhld,bhde->bhle", q.float(), new_kv)
    return out.to(q.dtype), new_kv


def _lib() -> ctypes.CDLL:
    lib = _build.load("linear_attention")
    fn = lib.linear_attention_step_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.linear_attention_step_max_dim.argtypes = []
        lib.linear_attention_step_max_dim.restype = ctypes.c_int
    return lib


def linear_attention_step(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop of state-carrying softmax-free attention.

    q, k, v: (B, H, L, D) float32, any L; kv: (B, H, D, D) float32 carried
    K^T V state. Returns ``(out, new_kv)`` with ``out = Q @ (kv + K^T V)``,
    unnormalized. CPU tensors take ``linear_attention_step_ref``; CUDA
    tensors launch the kernel (``linear_attention_step.launches`` counts).

    Raises:
        TypeError / ValueError: wrong dtype, rank, shape, contiguity or
            device mix, or D too large for the kernel.
        RuntimeError: the kernel could not be built or launched.
    """
    for name, t in (("q", q), ("k", k), ("v", v), ("kv", kv)):
        check_f32_contiguous(name, t, 4)
    B, H, L, D = q.shape
    if k.shape != q.shape or v.shape != q.shape or kv.shape != (B, H, D, D):
        raise ValueError(
            f"shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)} "
            f"kv={tuple(kv.shape)}: need q, k, v (B, H, L, D) and kv (B, H, D, D)"
        )
    if use_plain(q, k, v, kv):
        return linear_attention_step_ref(q, k, v, kv)
    out = torch.empty_like(q)
    new_kv = torch.empty_like(kv)
    if B * H == 0:
        return out, new_kv
    lib = _lib()
    if D > lib.linear_attention_step_max_dim():
        raise ValueError(f"linear_attention_step: D={D} exceeds the kernel's limit")
    rc = lib.linear_attention_step_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(),
        out.data_ptr(), new_kv.data_ptr(), B * H, L, D, stream_ptr(q),
    )
    check_launch("linear_attention_step", rc)
    linear_attention_step.launches += 1
    return out, new_kv


linear_attention_step.launches = 0
