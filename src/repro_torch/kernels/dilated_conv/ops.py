"""Channel-split dilated residual conv (Fig. 2b): plain version, kernel, wrapper.

Replaces the TPU kernel ``src/repro/kernels/dilated_conv/kernel.py``
(``_kernel`` / ``dilated_split_conv_pallas``) with ``csrc/dilated_conv.cu``.
On the card the call is bound by its launch, not by bytes or FLOPs (see the
source's header for the numbers and what the design does about them).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.runtime import check_f32_contiguous, check_launch, stream_ptr, use_plain


def dilated_split_conv_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    dilation: int = 1,
    zero_skip: bool = True,
    swap_halves: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version (mirrors ``repro/kernels/dilated_conv/ref.py``).

    x: (B, F, C); w: (k, C//2, C//2); b: (C//2,). The first C//2 channels go
    through the SAME-padded dilated conv, bias, ReLU and the residual; the
    rest pass through. ``zero_skip`` gives an all-zero frame the kernel's
    short cut ``relu(b) + x`` (equal to the computed path for finite w).
    """
    half = x.shape[-1] // 2
    xp, xb = x[..., :half], x[..., half:]
    k = w.shape[0]
    pad = (k - 1) * dilation // 2
    y = F.conv1d(xp.transpose(1, 2), w.permute(2, 1, 0), padding=pad, dilation=dilation)
    y = y.transpose(1, 2)
    if zero_skip:
        zero = (x == 0).flatten(1).all(dim=1)
        y = torch.where(zero[:, None, None], torch.zeros_like(y), y)
    y = torch.relu(y + b) + xp
    return torch.cat([xb, y] if swap_halves else [y, xb], dim=-1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("dilated_conv")
    fn = lib.dilated_split_conv_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.dilated_split_conv_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.dilated_split_conv_smem_bytes.restype = ctypes.c_int
    return lib


def dilated_split_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    dilation: int = 1,
    zero_skip: bool = True,
    swap_halves: bool = False,
) -> torch.Tensor:
    """Fused channel-split dilated residual conv on (B, F, C) float32.

    CPU tensors take ``dilated_split_conv_ref``; CUDA tensors launch the
    kernel (``dilated_split_conv.launches`` counts the launches).

    Raises:
        TypeError / ValueError: wrong dtype, rank, shape, contiguity or
            device mix.
        RuntimeError: the kernel could not be built or launched.
    """
    for name, t, nd in (("x", x, 3), ("w", w, 3), ("b", b, 1)):
        check_f32_contiguous(name, t, nd)
    B, Fr, C = x.shape
    k = w.shape[0]
    if C % 2 or w.shape[1:] != (C // 2, C // 2) or b.shape != (C // 2,):
        raise ValueError(
            f"shapes x={tuple(x.shape)} w={tuple(w.shape)} b={tuple(b.shape)}: "
            "need even C, w (k, C//2, C//2), b (C//2,)"
        )
    if dilation < 1 or ((k - 1) * dilation) % 2:
        raise ValueError(f"dilation={dilation} with k={k}: SAME padding needs even (k-1)*dilation")
    if use_plain(x, w, b):
        return dilated_split_conv_ref(
            x, w, b, dilation=dilation, zero_skip=zero_skip, swap_halves=swap_halves
        )
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _lib()
    smem = lib.dilated_split_conv_smem_bytes(C, k, dilation)
    if smem > 48 * 1024:
        raise ValueError(f"dilated_split_conv: {smem} B of shared memory exceeds 48 KB")
    rc = lib.dilated_split_conv_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        B, Fr, C, k, dilation, int(zero_skip), int(swap_halves), stream_ptr(x),
    )
    check_launch("dilated_split_conv", rc)
    dilated_split_conv.launches += 1
    return out


dilated_split_conv.launches = 0
