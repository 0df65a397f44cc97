"""The NVIDIA H100's rates and sizes, one source for every cost model of
the port: the roofline (:mod:`repro_torch.launch.roofline`, which
re-exports them), the planned einsum (:mod:`repro_torch.parallel.spmd`),
the CNN planner's card budget (:mod:`repro_torch.core.program`) and the
kernel bounds of ``chip_smoke.py``."""

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

# streaming multiprocessors of the H100 SXM5, and the blocks a SM the fused
# pyramid kernel is built to hold at once (kMinBlocks in
# csrc/fused_pyramid.cu): their product is the grid of its cooperative
# launch, which chip_smoke.py prints as "resident blocks" (264 at both
# dtypes)
SMS = 132
PYRAMID_BLOCKS_PER_SM = 2
PYRAMID_GRID = SMS * PYRAMID_BLOCKS_PER_SM
# torch.cuda.get_device_properties(0).L2_cache_size on an
# "NVIDIA H100 80GB HBM3" (50 MB by the datasheet; chip_smoke.py prints it)
L2_BYTES = 52_428_800
# the CNN planner's card budget (repro_torch.core.program.CARD_BUDGET): the
# most a fused pyramid launch may hold (scratch, split partial sums,
# weights, live flags) is the L2 itself, since its inter-level scratch
# saves HBM traffic only while it stays there.  chip_smoke.py's fusion
# sweep on "NVIDIA H100 80GB HBM3, 700.00 W" found no share of the L2,
# from 0.21x to 1.98x, past which fusion stops paying (it lost only at
# batches that fill the grid's last wave unevenly, and by 1.3-1.5 % at
# 1.98x).  Under this budget ResNet-18 made the same launches as under
# 1.97x the L2, and VGG-16 ran faster (PERF.md).  The sweep checks that
# fusion still pays within it
PLAN_BUDGET_BYTES = L2_BYTES
