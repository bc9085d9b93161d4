from repro_torch.kernels.masked_mac.ops import masked_matmul, masked_matmul_ref

__all__ = ["masked_matmul", "masked_matmul_ref"]
