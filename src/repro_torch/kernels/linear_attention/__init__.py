from repro_torch.kernels.linear_attention.ops import linear_attention_step, linear_attention_step_ref

__all__ = ["linear_attention_step", "linear_attention_step_ref"]
