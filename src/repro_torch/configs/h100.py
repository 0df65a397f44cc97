"""The NVIDIA H100's rates and sizes, one source for every cost model of
the port: the roofline (:mod:`repro_torch.launch.roofline`, which
re-exports them), the planned einsum (:mod:`repro_torch.parallel.spmd`)
and the kernel bounds of ``chip_smoke.py``."""

# NVIDIA H100 SXM5 datasheet (dense): float32 outside the tensor cores,
# bf16 and int8 on the tensor cores, and the HBM3 rate
PEAK_FLOPS_BY_TYPE = {"float32": 67e12, "bfloat16": 989e12,
                      "int8": 1979e12}
PEAK_FLOPS = PEAK_FLOPS_BY_TYPE["bfloat16"]  # FLOP/s a card
HBM_BW = 3.35e12  # bytes/s a card
# NVLink 4: 900 GB/s a card in both directions, 450 GB/s each way
NVLINK_BW = 450e9  # bytes/s a card, each way, inside one 8-card host
# InfiniBand NDR: 400 Gb/s a card (one ConnectX-7 each), across hosts
IB_BW = 50e9  # bytes/s a card
# torch.cuda.get_device_properties(0).total_memory on an
# "NVIDIA H100 80GB HBM3" (chip_smoke.py prints it in phase plan)
HBM_PER_CHIP = 85_017_493_504
# the mesh axes whose collectives stay inside one host, on NVLink
INTRA_HOST_AXES = ("model",)
