from repro_torch.kernels.dilated_conv.ops import dilated_split_conv, dilated_split_conv_ref

__all__ = ["dilated_split_conv", "dilated_split_conv_ref"]
