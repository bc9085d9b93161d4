"""STFT window (counterpart of ``repro/audio/stft.py``'s ``hann``)."""

from __future__ import annotations

import math

import torch


def hann(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window, computed as the reference computes it."""
    i = torch.arange(n, dtype=dtype, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * i / n))
