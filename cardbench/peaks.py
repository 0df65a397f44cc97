"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet,
dense rates without sparsity, at the full 700 W power limit).  The run
prints the card's own power limit beside every share taken against them."""

PEAK_FLOPS = {
    "float32": 67e12,  # FP32 on the CUDA cores (no tensor cores)
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "float8": 1979e12,
}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
