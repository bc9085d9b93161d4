"""Device policy shared by the port's entry points and kernel wrappers.

The counterpart of ``repro/kernels/runtime.py``, with a different rule:
there is no switch. A kernel wrapper looks at the device of the tensors it
is given. CPU tensors take the wrapper's plain PyTorch version (what the CPU
tests run); CUDA tensors launch the hand-written kernel, and a kernel that
cannot be built or launched raises. Nothing falls back from one to the other.

Entry points (``SessionPool``, ``make_stream_hop``, ``build_deploy_plan``,
the launcher) default to ``cuda`` and raise when CUDA is absent, unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises:
        RuntimeError: the device is a CUDA device and CUDA is not available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' to run its plain PyTorch versions instead"
        )
    return dev


def use_plain(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA ones (kernel).

    Raises:
        ValueError: the tensors lie on different devices, or on a device
            that is neither the CPU nor CUDA.
    """
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"unsupported device {dev}: expected cpu or cuda")


def check_f32_contiguous(name: str, t: torch.Tensor, ndim: Optional[int] = None) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of rank ``ndim``."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, rc: int) -> None:
    """Raise if a kernel's C launcher returned a non-zero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {rc}")
