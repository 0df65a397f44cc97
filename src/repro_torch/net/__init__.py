"""Whole-network fusion for the port: graph IR, memory-aware
auto-partitioner, runner.

* :mod:`repro_torch.net.graph` — CNN graph IR + the model zoo (LeNet-5,
  AlexNet, VGG-16, ResNet-18) and fusable-segment extraction.
* :mod:`repro_torch.net.partition` — the dynamic program over legal pyramid
  cuts minimizing modeled HBM traffic, then modeled latency, under the
  reference's (parity) budget.
* :mod:`repro_torch.net.runner` — ``run_network`` executing a
  :class:`~repro_torch.net.partition.PartitionPlan` as fused-pyramid
  launches plus residual adds and the classifier head; on a card, a CUDA
  graph captured per (plan, shape, dtype, params) and replayed
  (``jit_trace_count`` counts the captures).
* :mod:`repro_torch.net.serve` — continuous bucketed batching over the
  runner: admission through ``robust.validate.check_request``, pad-to-bucket
  execution through a plan cache keyed (graph, bucket, dtype), pinned
  host staging on a side CUDA stream, per-bucket modeled-SLO vs measured
  latency, deadline/priority EDF admission with load shedding, a
  per-bucket circuit breaker, a watchdog, and an output sentinel.
* :mod:`repro_torch.net.frontend` — the concurrent front end: thread-safe
  ``submit`` returning Future-style handles, one background drain thread.
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
    jit_trace_count,
    prepare_network_params,
    reference_network,
    reset_jit_trace_count,
    run_model,
    run_network,
    skip_fractions,
)

# serve.py loads lazily so `python -m repro_torch.net.serve` doesn't import
# the module twice (once as repro_torch.net.serve, once as __main__)
_LAZY_SERVE = (
    "Request", "RequestResult", "ServeConfig", "ServingEngine",
    "bucket_for", "pad_to_bucket",
)
_LAZY_FRONTEND = ("RequestHandle", "ServingFrontend")


def __getattr__(name: str):
    if name in _LAZY_SERVE:
        from . import serve

        return getattr(serve, name)
    if name in _LAZY_FRONTEND:
        from . import frontend

        return getattr(frontend, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "MODELS",
    "Graph",
    "Node",
    "PartitionPlan",
    "PyramidPlan",
    "Request",
    "RequestHandle",
    "RequestResult",
    "ServeConfig",
    "ServingEngine",
    "ServingFrontend",
    "auto_partition",
    "bf16_logit_tol",
    "bucket_for",
    "fusable_segments",
    "infer_shapes",
    "init_network_params",
    "jit_trace_count",
    "layerwise_partition",
    "pad_to_bucket",
    "paper_partition",
    "prepare_network_params",
    "reference_network",
    "reset_jit_trace_count",
    "run_model",
    "run_network",
    "skip_fractions",
]
