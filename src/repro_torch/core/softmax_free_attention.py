"""Softmax-free attention with BN-normalized Q/K, optimal matmul order.

Counterpart of ``repro/core/softmax_free_attention.py``, non-causal mode
(the sub-band attention of TFTNN): without softmax, attention is the
associative chain ``out = Q_bn @ (K_bn^T @ V) / L``, so the (D, D) product
K^T V is formed first (Eq. 1, Fig. 10b). The product goes through
``kernels.linear_attention`` (plain version on the CPU, CUDA kernel on the
card). The causal and one-token step modes belong to the LM side and are
not ported yet.

Shapes follow (batch, heads, length, head_dim) = (B, H, L, D).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.linear_attention import linear_attention


def _bn_qk(q: torch.Tensor, k: torch.Tensor, qk_stats: Optional[Dict[str, torch.Tensor]]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a constant (inference-mode) BN affine to Q and K per head-dim.

    qk_stats: optional dict with 'q_scale', 'q_bias', 'k_scale', 'k_bias'
    of shape (D,), the collapsed BN affine (``core.bn.bn_scale_shift``).
    """
    if qk_stats is None:
        return q, k
    q = q * qk_stats["q_scale"] + qk_stats["q_bias"]
    k = k * qk_stats["k_scale"] + qk_stats["k_bias"]
    return q, k


def softmax_free_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    qk_stats: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Non-causal softmax-free attention, ``Q @ (K^T V) / L``.

    q, k, v: (..., L, D) float32 with any leading batch/head dims; the
    leading dims are flattened into the kernel's (N, 1, L, D) layout.
    Cost: O(L * D^2) instead of O(L^2 * D) (Eq. 1: ratio = L/D).
    """
    q, k = _bn_qk(q, k, qk_stats)
    *lead, L, D = q.shape

    def flat(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(-1, 1, L, D).contiguous()

    return linear_attention(flat(q), flat(k), flat(v)).reshape(*lead, L, D)
