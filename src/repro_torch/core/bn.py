"""BatchNorm with constant inference statistics, and its folding.

Counterpart of ``repro/core/bn.py`` for what the deploy path needs: the
parameter layout, the per-channel affine of an inference-mode BN, and the
exact folds into an adjacent linear layer or convolution.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BatchNorm:
    """Feature-axis batch normalization (parameter layout only)."""

    num_features: int

    def init(self, dtype=torch.float32) -> Params:
        f = self.num_features
        return {
            "scale": torch.ones((f,), dtype=dtype),
            "bias": torch.zeros((f,), dtype=dtype),
            "mean": torch.zeros((f,), dtype=dtype),
            "var": torch.ones((f,), dtype=dtype),
        }


def bn_scale_shift(bn_params: Params, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapse BN to a per-channel affine y = a*x + b (inference mode)."""
    a = torch.rsqrt(bn_params["var"] + eps) * bn_params["scale"]
    b = bn_params["bias"] - bn_params["mean"] * a
    return a, b


def fold_bn_into_linear(
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    bn_params: Params,
    *,
    eps: float = 1e-5,
    pre: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an inference-mode BN into an adjacent linear layer.

    ``pre=False`` folds ``BN(x @ w + b)``  -> ``x @ w' + b'``   (BN after)
    ``pre=True``  folds ``BN(x) @ w + b``  -> ``x @ w' + b'``   (BN before)

    w: (in, out). Returns (w', b').
    """
    a, c = bn_scale_shift(bn_params, eps)
    if b is None:
        b = torch.zeros((w.shape[-1],), dtype=w.dtype, device=w.device)
    if pre:
        return w * a[:, None], c @ w + b
    return w * a[None, :], a * b + c


def fold_bn_into_conv2d(
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    bn_params: Params,
    *,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold BN after a 2-D conv. w: (kf, kt, in, out). Returns (w', b')."""
    a, c = bn_scale_shift(bn_params, eps)
    if b is None:
        b = torch.zeros((w.shape[-1],), dtype=w.dtype, device=w.device)
    return w * a, a * b + c
