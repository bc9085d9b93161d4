"""Hand-written CUDA kernels for the deployed hop, each beside its plain
PyTorch version (see ``runtime.py`` for the dispatch rule)."""

from repro_torch.kernels.dilated_conv import dilated_split_conv
from repro_torch.kernels.linear_attention import linear_attention_step
from repro_torch.kernels.masked_mac import masked_matmul

KERNELS = (dilated_split_conv, linear_attention_step, masked_matmul)

__all__ = ["KERNELS", "dilated_split_conv", "linear_attention_step", "masked_matmul"]
