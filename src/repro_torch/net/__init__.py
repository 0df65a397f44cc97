"""Whole-network fusion for the port: graph IR, memory-aware
auto-partitioner, runner.

* :mod:`repro_torch.net.graph` — CNN graph IR + the model zoo (LeNet-5,
  AlexNet, VGG-16, ResNet-18) and fusable-segment extraction.
* :mod:`repro_torch.net.partition` — the dynamic program over legal pyramid
  cuts minimizing modeled HBM traffic, then modeled latency, under the
  reference's (parity) budget.
* :mod:`repro_torch.net.runner` — ``run_network`` executing a
  :class:`~repro_torch.net.partition.PartitionPlan` as fused-pyramid
  launches plus residual adds and the classifier head.
"""

from .graph import MODELS, Graph, Node, fusable_segments, infer_shapes
from .partition import (
    PartitionPlan,
    PyramidPlan,
    auto_partition,
    layerwise_partition,
    paper_partition,
)
from .runner import (
    bf16_logit_tol,
    init_network_params,
    prepare_network_params,
    reference_network,
    run_model,
    run_network,
    skip_fractions,
)

__all__ = [
    "MODELS",
    "Graph",
    "Node",
    "PartitionPlan",
    "PyramidPlan",
    "auto_partition",
    "bf16_logit_tol",
    "fusable_segments",
    "infer_shapes",
    "init_network_params",
    "layerwise_partition",
    "paper_partition",
    "prepare_network_params",
    "reference_network",
    "run_model",
    "run_network",
    "skip_fractions",
]
