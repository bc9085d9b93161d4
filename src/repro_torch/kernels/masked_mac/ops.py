"""Masked-MAC (pruned) matmul: plain version, kernel, wrapper.

Replaces the TPU kernel ``src/repro/kernels/masked_mac/kernel.py``
(``_kernel`` / ``masked_matmul_pallas``) with ``csrc/masked_mac.cu``, for the
reference's ``mask=None`` runtime path (``ops.py:796-802``): the weight
already holds its zeros and the kernel skips all-zero ``block_k``-row strips
at run time. The host-side ``skip_plan`` decomposition for concrete masks
comes with pruning, which is not ported yet. On the card the call is bound
by its launch, not by bytes or FLOPs (see the source's header).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.runtime import check_f32_contiguous, check_launch, stream_ptr, use_plain


def masked_matmul_ref(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain version (mirrors ``repro/kernels/masked_mac/ref.py``, no mask).

    y = x @ w + b in fp32. x: (..., K); w: (K, N).
    """
    y = x.float() @ w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("masked_mac")
    fn = lib.masked_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.masked_matmul_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.masked_matmul_smem_bytes.restype = ctypes.c_int
    return lib


def masked_matmul(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, block_k: int = 8
) -> torch.Tensor:
    """y = x @ w + b over a pruned w, skipping all-zero ``block_k`` strips.

    x: (..., K) float32, leading axes flattened into rows, any M and K;
    w: (K, N); b: (N,). CPU tensors take ``masked_matmul_ref``; CUDA tensors
    launch the kernel (``masked_matmul.launches`` counts the launches).

    Raises:
        TypeError / ValueError: wrong dtype, rank, shape, contiguity or
            device mix, or a weight too large for shared memory.
        RuntimeError: the kernel could not be built or launched.
    """
    check_f32_contiguous("x", x)
    check_f32_contiguous("w", w, 2)
    check_f32_contiguous("b", b, 1)
    K, N = w.shape
    if x.dim() < 1 or x.shape[-1] != K or b.shape != (N,) or block_k < 1:
        raise ValueError(
            f"shapes x={tuple(x.shape)} w={tuple(w.shape)} b={tuple(b.shape)} "
            f"block_k={block_k}: need x (..., K), w (K, N), b (N,), block_k >= 1"
        )
    if use_plain(x, w, b):
        return masked_matmul_ref(x, w, b)
    lead = x.shape[:-1]
    xf = x.reshape(-1, K)
    M = xf.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out.reshape(*lead, N)
    lib = _lib()
    smem = lib.masked_matmul_smem_bytes(K, N, block_k)
    if smem > 48 * 1024:
        raise ValueError(f"masked_matmul: {smem} B of shared memory exceeds 48 KB")
    rc = lib.masked_matmul_launch(
        xf.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        M, K, N, block_k, stream_ptr(x),
    )
    check_launch("masked_matmul", rc)
    masked_matmul.launches += 1
    return out.reshape(*lead, N)


masked_matmul.launches = 0
