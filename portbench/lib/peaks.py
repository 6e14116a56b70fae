"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at the full 700 W).

TF32 is the fastest rate at which a float32-correct product can run on
the tensor cores (three TF32 passes of the split operands make it exact
to f32's error), so an f32 model's share of the chip is taken against
it, whatever precision a kernel actually multiplies in."""
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12
