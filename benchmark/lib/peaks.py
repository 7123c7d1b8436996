"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): the yardstick of every roofline share and
of `mfu`."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12          # bf16 and fp16 tensor cores
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12           # f32 outside the tensor cores (TF32 off)
FP64_FLOPS = 67e12           # f64 tensor cores

# the peak an operation runs at, by its operands' dtype name
BY_DTYPE = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
            "float32": FP32_FLOPS, "float64": FP64_FLOPS}
