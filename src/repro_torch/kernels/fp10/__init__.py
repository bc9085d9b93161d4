from repro_torch.kernels.fp10.ops import fp10_quantize, fp10_quantize_ref

__all__ = ["fp10_quantize", "fp10_quantize_ref"]
