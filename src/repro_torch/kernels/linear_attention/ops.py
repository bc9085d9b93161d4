"""Softmax-free (linear) attention: plain versions, kernels, wrappers.

Replaces two TPU kernels of ``src/repro/kernels/linear_attention/kernel.py``
with ``csrc/linear_attention.cu``:

- ``linear_attention_step`` (``_step_kernel`` /
  ``linear_attention_step_pallas``): the deployed hop's state-carrying
  step;
- ``linear_attention`` (``_noncausal_kernel`` / ``linear_attention_pallas``):
  ``Q @ (K^T V) / L``, the training graph's sub-band attention.

Each wrapper counts its own launches. On the card the hop's calls are bound
by their launch, not by bytes or FLOPs (see the source's header). The causal
Pallas kernel of the same file belongs to the LM side and is not ported yet.
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


def linear_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version (mirrors ``repro/kernels/linear_attention/ref.py``).

    out = Q @ (K^T V) / L, non-causal, in fp32.
    """
    L = q.shape[-2]
    kv = torch.einsum("bhld,bhle->bhde", k.float(), v.float())
    out = torch.einsum("bhld,bhde->bhle", q.float(), kv) / L
    return out.to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("linear_attention")
    fn = lib.linear_attention_step_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.linear_attention_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.linear_attention_launch.restype = ctypes.c_int
        lib.linear_attention_step_max_dim.argtypes = []
        lib.linear_attention_step_max_dim.restype = ctypes.c_int
    return lib


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_f32_contiguous(name, t, 4)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}: "
            f"need q, k, v (B, H, L, D)"
        )


def _kernel_lib(D: int) -> ctypes.CDLL:
    lib = _lib()
    if D > lib.linear_attention_step_max_dim():
        raise ValueError(f"linear attention: D={D} exceeds the kernel's limit "
                         f"{lib.linear_attention_step_max_dim()}")
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
    _check_qkv(q, k, v)
    check_f32_contiguous("kv", kv, 4)
    B, H, L, D = q.shape
    if kv.shape != (B, H, D, D):
        raise ValueError(f"kv={tuple(kv.shape)}: need (B, H, D, D) = {(B, H, D, D)}")
    if use_plain(q, k, v, kv):
        return linear_attention_step_ref(q, k, v, kv)
    out = torch.empty_like(q)
    new_kv = torch.empty_like(kv)
    if B * H == 0:
        return out, new_kv
    rc = _kernel_lib(D).linear_attention_step_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(),
        out.data_ptr(), new_kv.data_ptr(), B * H, L, D, stream_ptr(q),
    )
    check_launch("linear_attention_step", rc)
    linear_attention_step.launches += 1
    return out, new_kv


linear_attention_step.launches = 0


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal softmax-free attention, optimal order: Q @ (K^T V) / L.

    q, k, v: (B, H, L, D) float32, contiguous, any L >= 1 (no padding or
    renormalising, unlike the reference's Pallas wrapper). CPU tensors take
    ``linear_attention_ref``; CUDA tensors launch the kernel
    (``linear_attention.launches`` counts, apart from the step kernel's).

    Raises:
        TypeError / ValueError: wrong dtype, rank, shape, contiguity or
            device mix, L = 0, or D too large for the kernel.
        RuntimeError: the kernel could not be built or launched.
    """
    _check_qkv(q, k, v)
    B, H, L, D = q.shape
    if L == 0:
        raise ValueError("linear_attention: L = 0 has no 1/L normalizer")
    if use_plain(q, k, v):
        return linear_attention_ref(q, k, v)
    out = torch.empty_like(q)
    if B * H == 0:
        return out
    rc = _kernel_lib(D).linear_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, L, D, stream_ptr(q),
    )
    check_launch("linear_attention", rc)
    linear_attention.launches += 1
    return out


linear_attention.launches = 0
