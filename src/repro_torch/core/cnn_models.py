"""CNN workload definitions used by the paper (§4.1), derived from the
graph IR.

The port of the reference package's ``repro.core.cnn_models``.  The full
networks live as graphs in :mod:`repro_torch.net.graph` (the model zoo:
LeNet-5, AlexNet, VGG-16, ResNet-18, and ResNet-50, which only the port
has); this module derives the paper's *hand-picked fusion choices* for the
first four: LeNet-5 / AlexNet fuse the first two conv layers (+ their
pools); VGG-16 fuses the first two blocks (four convs + two pools);
ResNet-18 fuses the conv pair inside each residual block (stem conv
excluded).  The paper picks no fusion groups for ResNet-50; the
partitioner plans it.
"""

from __future__ import annotations

from repro_torch.net import graph as _zoo

from .fusion import FusedLevel, FusionSpec

# ---------------------------------------------------------------------------
# Paper fusion groups, derived from the zoo graphs
# ---------------------------------------------------------------------------

LENET5_INPUT = 32
LENET5_FUSION = _zoo.backbone_prefix(_zoo.lenet5(LENET5_INPUT), 2)
LENET5_LEVELS = LENET5_FUSION.levels

ALEXNET_INPUT = 227
ALEXNET_FUSION = _zoo.backbone_prefix(_zoo.alexnet(ALEXNET_INPUT), 2)
ALEXNET_LEVELS = ALEXNET_FUSION.levels

VGG_INPUT = 224
VGG_FUSION = _zoo.backbone_prefix(_zoo.vgg16(VGG_INPUT), 4)
VGG_BLOCK12_LEVELS = VGG_FUSION.levels


# ---------------------------------------------------------------------------
# ResNet-18 (224x224x3) — §4.3 END experiment: fuse conv pairs per block
# ---------------------------------------------------------------------------


def resnet18_fusions(input_size: int = 224) -> list[FusionSpec]:
    """Fusion pyramid per residual block (convA -> convB), derived from the
    ResNet-18 graph's body segments; stem and projection shortcuts excluded
    per the paper."""
    g = _zoo.resnet18(input_size)
    return [
        seg.spec()
        for seg in _zoo.fusable_segments(g)
        if seg.nodes[0].name.endswith("_convA")
    ]


def resnet18_block_fusion(n_in: int, n_out: int, ifm: int, s1: int) -> FusionSpec:
    """Fusion pyramid for one residual block: conv3x3(s1) -> conv3x3(1)."""
    return FusionSpec(
        levels=(
            FusedLevel("conv", K=3, S=s1, pad=1, n_in=n_in, n_out=n_out, name="convA"),
            FusedLevel("conv", K=3, S=1, pad=1, n_in=n_out, n_out=n_out, name="convB"),
        ),
        input_size=ifm,
    )


# ---------------------------------------------------------------------------
# Paper Table 1/2 "Number of Operations" (as printed; the paper's own
# 2*M*N*R*C*K*K accounting is not internally consistent)
# ---------------------------------------------------------------------------

PAPER_OPS = {
    ("lenet", "CONV1"): 235_200,
    ("lenet", "CONV2"): 940_800,
    ("lenet", "Fused"): 1_183_880,
    ("alexnet", "CONV1"): 105_415_200,
    ("alexnet", "CONV2"): 223_948_800,
    ("alexnet", "Fused"): 329_659_136,
    ("vgg", "CONV1"): 173_408_256,
    ("vgg", "CONV2"): 3_699_376_128,
    ("vgg", "CONV3"): 1_849_688_064,
    ("vgg", "CONV4"): 3_699_376_128,
    ("vgg", "Fused"): 9_429_625_856,
}


def conv_ops(level: FusedLevel, out_size: int) -> int:
    """2*M*N*R*C*K*K (Eq. 2's numerator) for one conv level."""
    return 2 * level.n_out * level.n_in * out_size * out_size * level.K * level.K


NETWORKS = {
    "lenet": LENET5_FUSION,
    "alexnet": ALEXNET_FUSION,
    "vgg": VGG_FUSION,
}

# Paper-matching output-region pins: these yield alpha = 5 / 9 / 3
# respectively via Algorithm 4.
PAPER_OUT_REGION = {"lenet": 1, "alexnet": 1, "vgg": None}  # vgg: scan smallest
