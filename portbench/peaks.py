"""The H100 SXM's published peaks (NVIDIA's data sheet, dense, at the
700 W limit): the bf16 rate and the HBM rate as the port's
``roofline/analysis.py`` has them, and the TF32 tensor-core rate, the
highest rate for products of float32 inputs."""
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
HBM_BYTES = 3.35e12
