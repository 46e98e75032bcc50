"""Published peaks of one NVIDIA H100 SXM (the data sheet's dense rates, at
the full 700 W): the yardstick of every roofline share and of ``mfu``."""

BF16_FLOPS = 989e12  # tensor cores, bf16 in, f32 accumulate
HBM_BYTES = 3.35e12  # bytes a second
# f32 instructions a second outside the tensor cores: half of the published
# 67 TFLOP/s, since an FMA counts 2 FLOPs and is one instruction
F32_INSTRUCTIONS = 67e12 / 2


def bound_s(n_bytes: float, tensor_flops: float, f32_instructions: float) -> float:
    """The least time the card could take for a call: the largest of its
    bytes over the memory rate, its tensor-core FLOPs over the bf16 peak and
    its f32 instructions over the instruction rate."""
    return max(n_bytes / HBM_BYTES, tensor_flops / BF16_FLOPS,
               f32_instructions / F32_INSTRUCTIONS)
