"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), which rooflines are shares of."""

#: device memory rate, bytes per second
HBM_BYTES_PER_S = 3.35e12
#: dense operations per second by operand type
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
              "float16": 989e12, "fp8": 1979e12, "int8": 1979e12}
