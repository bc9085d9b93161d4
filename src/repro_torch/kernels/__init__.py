"""Hand-written CUDA kernels, each beside its plain PyTorch version (see
``runtime.py`` for the dispatch rule).

The non-causal ``linear_attention`` wrapper is imported from its subpackage
(``repro_torch.kernels.linear_attention``), whose name it shares.
"""

from repro_torch.kernels.dilated_conv import dilated_split_conv
from repro_torch.kernels.fp10 import fp10_quantize
from repro_torch.kernels.linear_attention import ops as _linear_attention_ops
from repro_torch.kernels.linear_attention import linear_attention_step
from repro_torch.kernels.masked_mac import masked_matmul

KERNELS = (dilated_split_conv, linear_attention_step, masked_matmul, fp10_quantize,
           _linear_attention_ops.linear_attention)

__all__ = ["KERNELS", "dilated_split_conv", "fp10_quantize", "linear_attention_step",
           "masked_matmul"]
