"""End-to-end batched network execution: ``run_network`` and its oracle.

The port of the reference's ``repro.net.runner``.  ``run_network`` executes
a :class:`~repro_torch.net.partition.PartitionPlan` as a sequence of
fused-pyramid launches (one per chosen pyramid) stitched together with the
plain PyTorch ops the plan left outside pyramids: residual adds, standalone
activations, global pooling, flatten, and the dense classifier head.  The
reference compiles the whole forward with ``jax.jit``; PyTorch runs it
eagerly, one kernel launch per pyramid.  The per-launch END skip flag maps
are returned alongside the logits.

``reference_network`` is the monolithic oracle: the same graph executed
node by node with full intermediate feature maps.  ``run_network`` must
match it to float32 ``atol 1e-4`` end to end — the contract that lets the
auto-partitioner move fusion boundaries without changing results.

Low precision (DESIGN.md §11): ``run_network(..., dtype="bfloat16")`` (or
a bf16-planned partition) moves every activation tile, weight and dense
operand at bf16 while every accumulation — conv, dense matmul, the
global-average-pool mean — runs in float32.  Logits then differ from the
float32 reference only by operand rounding, bounded by
:func:`bf16_logit_tol`.

Observed and guarded forwards (DESIGN.md §12, §13): under
``repro_torch.obs.tracing()`` each launch is timed (CUDA events on a card)
and recorded as a span; under ``repro_torch.robust.guarding()`` the forward
runs :func:`repro_torch.robust.degrade.run_network_guarded` — preflight,
per-launch sentinels and the degradation ladder.  The reference's
``jit_trace_count`` retrace counter comes with the serving slice.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import resolve_device
from repro_torch.core.cycle_model import DEFAULT_PARAMS
from repro_torch.core.dtypes import canonical_dtype, torch_dtype
from repro_torch.core.executor import conv2d_nhwc, full_fp32, maxpool_nhwc
from repro_torch.kernels.fused_conv.ops import flatten_weights, fused_pyramid
from repro_torch.obs.trace import LaunchSpan, SpanTimer, device_label, get_tracer
from repro_torch.robust.errors import PreflightError
from repro_torch.robust.guard import get_guard

from .graph import Graph, Node, infer_shapes
from .partition import PartitionPlan, auto_partition

Params = dict[str, tuple[torch.Tensor, torch.Tensor]]

# key prefix of pre-flattened streamed-weight arrays in a params dict
_FLAT = "_flat/"

# Documented end-to-end bf16 logit tolerance vs the f32 reference (the
# reference's values): bf16 keeps 8 mantissa bits, so each layer's operands
# round to ~2^-9 relative error while accumulation stays float32, and the
# end-to-end error is relative to the logit magnitude.  The contract is
# ``max-abs-err <= ATOL + RTOL * max|logit|``.
BF16_LOGIT_ATOL = 0.05
BF16_LOGIT_RTOL = 0.02


def bf16_logit_tol(reference) -> float:
    """The documented bf16-vs-f32 max-abs-err bound for a given f32
    reference logit tensor (see :data:`BF16_LOGIT_RTOL`)."""
    if isinstance(reference, torch.Tensor):
        peak = float(reference.detach().float().abs().max())
    else:
        peak = float(np.abs(np.asarray(reference, dtype=np.float32)).max())
    return BF16_LOGIT_ATOL + BF16_LOGIT_RTOL * peak


def init_network_params(
    graph: Graph, *, seed: int = 0, scale: float = 1.0, device=None
) -> Params:
    """He-initialized float32 weights for every conv and dense node, keyed
    by node name: conv ``(K, K, Cin, Cout)`` + bias, dense ``(fan_in,
    n_out)`` + bias.  Drawn from a ``torch.Generator`` seeded with ``seed``
    on the CPU (so the numbers do not depend on the device), then placed on
    ``device`` (``None`` = the CUDA card)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    shapes = infer_shapes(graph)
    params: Params = {}
    for n in graph.nodes:
        if n.op not in ("conv", "dense"):
            continue
        c_in = shapes[n.inputs[0]].channels
        fan_in = (n.K * n.K * c_in) if n.op == "conv" else c_in
        shape = (n.K, n.K, c_in, n.n_out) if n.op == "conv" else (c_in, n.n_out)
        w = torch.randn(shape, generator=gen) * (scale * (2.0 / fan_in) ** 0.5)
        b = torch.randn((n.n_out,), generator=gen) * 0.01
        params[n.name] = (w.to(dev), b.to(dev))
    return params


def _conv_node(x, n: Node, w, b):
    # float32 accumulation at any operand dtype (bf16 values are exact in
    # float32), cast back to the network's compute dtype
    out = conv2d_nhwc(x.float(), w.float(), b.float(), n.S, n.pad)
    out = torch.relu(out) if n.relu else out
    return out.to(x.dtype)


def _pool_node(x, n: Node):
    return maxpool_nhwc(x, n.K, n.S, n.pad)


def _head_op(values, n: Node, params: Params, graph: Graph | None = None):
    if n.op == "relu":
        return torch.relu(values[n.inputs[0]])
    if n.op == "add":
        return values[n.inputs[0]] + values[n.inputs[1]]
    if n.op == "global_pool":
        # mean in float32, cast back to the network dtype once
        x = values[n.inputs[0]]
        return x.float().mean(dim=(1, 2)).to(x.dtype)
    if n.op == "flatten":
        x = values[n.inputs[0]]
        return x.reshape(x.shape[0], -1)
    if n.op == "dense":
        x = values[n.inputs[0]]
        w, b = params[n.name]
        # operands at the network dtype, accumulation in float32
        out = x.float() @ w.to(x.dtype).float() + b.float()
        out = torch.relu(out) if n.relu else out
        return out.to(x.dtype)
    raise PreflightError(
        f"node {n.name!r} has op {n.op!r}, which the runner cannot execute"
        " (expected one of relu/add/global_pool/flatten/dense outside"
        " pyramids)",
        node=n.name, op=n.op,
        graph=graph.name if graph is not None else None,
    )


def reference_network(x: torch.Tensor, graph: Graph, params: Params) -> torch.Tensor:
    """Monolithic node-by-node forward: full intermediate maps, no fusion,
    float32.  Ground truth for ``run_network``."""
    values = {graph.nodes[0].name: x.float()}
    with full_fp32():
        for n in graph.nodes[1:]:
            if n.op == "conv":
                w, b = params[n.name]
                values[n.name] = _conv_node(values[n.inputs[0]], n, w, b)
            elif n.op == "pool":
                values[n.name] = _pool_node(values[n.inputs[0]], n)
            else:
                values[n.name] = _head_op(values, n, params, graph)
    return values[graph.output.name]


def prepare_network_params(
    plan: PartitionPlan, params: Params, dtype: str | None = None
) -> Params:
    """Cast params to the plan's compute dtype and pre-flatten streamed
    weights, once per model.

    ``dtype`` (``None`` = ``plan.compute_dtype``) is the value width the
    launches move; each streamed pyramid gets one ``"_flat/<pyramid>"``
    concatenated weight array at that width (consumed by
    :func:`run_network`).  Master params stay float32 in the caller's dict —
    this returns a new dict.  Stale ``"_flat/"`` entries are dropped and
    rebuilt."""
    cdt = canonical_dtype(plan.compute_dtype if dtype is None else dtype)
    tdt = torch_dtype(cdt)
    out: Params = {
        k: (w.to(tdt), b.to(tdt))
        for k, (w, b) in params.items()
        if not k.startswith(_FLAT)
    }
    graph = plan.graph
    for pyr in plan.pyramids:
        if not pyr.launch.streamed:
            continue
        conv_names = [m for m in pyr.node_names if graph.node(m).op == "conv"]
        out[_FLAT + pyr.name] = flatten_weights(
            [out[m][0] for m in conv_names], cdt
        )
    return out


def _forward(
    x: torch.Tensor,
    params: Params,
    *,
    plan: PartitionPlan,
    end_skip: bool,
    cdt: str,
    launch_wrapper=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The plan-driven forward loop, shared by the plain, the traced and
    the guarded path.  ``launch_wrapper(pyr, call, x_in)``, when given,
    wraps each fused-pyramid launch — the traced path times it there, the
    guarded path (``repro_torch.robust.degrade``) runs its degradation
    ladder there, using ``x_in`` for replans and reference quarantines;
    ``call(**kw)`` re-issues the launch with keyword overrides, e.g.
    ``call(plain=True)`` on the ladder's eager rung."""
    tdt = torch_dtype(cdt)
    graph = plan.graph
    covered = plan.covered()
    values = {graph.nodes[0].name: x.to(tdt)}
    skips: dict[str, torch.Tensor] = {}
    for n in graph.nodes[1:]:
        if n.name in covered:
            pyr = plan.pyramid_at(n.name)
            if pyr is None:
                continue  # interior pyramid node: computed with its launch
            conv_names = [m for m in pyr.node_names
                          if graph.node(m).op == "conv"]
            flat = params.get(_FLAT + pyr.name)
            x_in = values[n.inputs[0]]

            def call(pyr=pyr, x_in=x_in, conv_names=conv_names, flat=flat,
                     **overrides):
                kwargs = dict(
                    spec=pyr.spec,
                    out_region=pyr.launch.out_region,
                    streamed=pyr.launch.streamed,
                    w_slots=(
                        pyr.launch.w_slots if pyr.launch.streamed else None
                    ),
                    x_slots=pyr.launch.x_slots,
                    c_tiles=pyr.launch.c_tiles,
                    relu=pyr.relu,
                    end_skip=end_skip,
                    vmem_budget=plan.vmem_budget,
                    weights_flat=flat,
                    compute_dtype=cdt,
                )
                kwargs.update(overrides)
                return fused_pyramid(
                    x_in,
                    # streamed launches with pre-flattened weights don't
                    # need the per-level tensors
                    None if kwargs["weights_flat"] is not None
                    else [params[m][0] for m in conv_names],
                    [params[m][1] for m in conv_names],
                    **kwargs,
                )

            y, skip = call() if launch_wrapper is None else launch_wrapper(
                pyr, call, x_in
            )
            values[pyr.node_names[-1]] = y
            skips[pyr.name] = skip
        elif n.op == "conv":
            w, b = params[n.name]
            values[n.name] = _conv_node(
                values[n.inputs[0]], n, w.to(tdt), b.to(tdt)
            )
        elif n.op == "pool":
            values[n.name] = _pool_node(values[n.inputs[0]], n)
        else:
            values[n.name] = _head_op(values, n, params, graph)
    return values[graph.output.name], skips


def _run_network_traced(x, params, tracer, *, plan, end_skip, cdt):
    """The observed forward: the same plan, every launch recorded as a
    :class:`LaunchSpan` whose modeled fields come straight from the plan
    and whose ``duration_ms`` is the launch's CUDA-event time (host wall
    clock for CPU tensors), plus per-launch END-skip count events and one
    ``run_network`` summary event."""
    model = plan.graph.name
    batch = int(x.shape[0])
    device = device_label(x.device)

    def wrapper(pyr, call, x_in):
        timer = SpanTimer(device=x_in.device).start()
        y, skip = call()
        dur_ms = timer.stop_ms()
        d = pyr.launch.describe(batch, plan.vmem_budget)
        tracer.record_span(LaunchSpan(
            name=pyr.name,
            model=model,
            regime=d["regime"],
            out_region=d["out_region"],
            alpha=d["alpha"],
            q_convs=d["q_convs"],
            x_slots=d["x_slots"],
            w_slots=d["w_slots"],
            c_tiles=d["c_tiles"],
            batch=batch,
            compute_dtype=cdt,
            streamed=d["streamed"],
            hbm_bytes=d["hbm_bytes"],
            vmem_bytes=d["vmem_bytes"],
            modeled_cycles=d["modeled_cycles"],
            modeled_us=d["modeled_cycles"] / DEFAULT_PARAMS.freq_mhz,
            start_s=timer.start_s,
            duration_ms=dur_ms,
            device=device,
        ))
        return y, skip

    t0 = time.perf_counter()
    logits, skips = _forward(
        x, params, plan=plan, end_skip=end_skip, cdt=cdt,
        launch_wrapper=wrapper,
    )
    if logits.is_cuda:
        torch.cuda.synchronize(logits.device)
    total_ms = (time.perf_counter() - t0) * 1e3
    for name, skip in skips.items():
        arr = skip.cpu().numpy()
        # per-level count of grid cells the END cascade skipped, plus the
        # cell total (level 0 never skips by construction)
        tracer.record_event(
            "end_skip_counts",
            model=model,
            launch=name,
            per_level=[int(c) for c in arr.sum(axis=(0, 1, 2))],
            cells=int(arr[..., 0].size),
        )
    tracer.record_event(
        "run_network",
        model=model,
        batch=batch,
        compute_dtype=cdt,
        launches=len(skips),
        wallclock_ms=total_ms,
        modeled_cycles=plan.modeled_cycles(),
    )
    return logits, skips


def run_network(
    x: torch.Tensor,
    params: Params,
    *,
    plan: PartitionPlan,
    end_skip: bool = True,
    dtype: str | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Execute the partition plan end to end for a batch ``x`` (B, H, W, C).

    Runs on the device of ``x`` and ``params``: every pyramid launches the
    CUDA kernel for CUDA tensors and its plain PyTorch version for CPU
    tensors.  ``dtype`` (name string or torch dtype, ``None`` =
    ``plan.compute_dtype``) is the compute dtype of the whole forward; the
    logits come back at it.  Params may come through
    :func:`prepare_network_params` so streamed launches reuse the
    pre-flattened weight arrays (which must match the run dtype).

    Returns ``(logits, skips)``: ``skips[pyramid.name]`` is that launch's
    ``(B, alpha, alpha, Q)`` int32 END-cascade flag map.  Aggregate with
    :func:`skip_fractions`.

    With a guard installed (``repro_torch.robust.guarding()``) the forward
    runs :func:`repro_torch.robust.degrade.run_network_guarded` instead:
    preflight, a numeric sentinel read on the host per launch, and the
    degradation ladder.  Otherwise, with a tracer installed
    (``repro_torch.obs.tracing()``) each launch is timed and recorded as a
    span.  The default no-op guard and tracer cost one attribute check
    each.
    """
    guard = get_guard()
    with full_fp32():
        if guard.enabled:
            from repro_torch.robust.degrade import run_network_guarded

            return run_network_guarded(
                x, params, plan=plan, end_skip=end_skip, dtype=dtype,
                guard=guard,
            )
        cdt = canonical_dtype(plan.compute_dtype if dtype is None else dtype)
        tracer = get_tracer()
        if not tracer.enabled:
            return _forward(x, params, plan=plan, end_skip=end_skip, cdt=cdt)
        return _run_network_traced(
            x, params, tracer, plan=plan, end_skip=end_skip, cdt=cdt
        )


def skip_fractions(skips: dict[str, torch.Tensor]) -> dict[str, list[float]]:
    """Per-pyramid, per-level fraction of tiles the END cascade skipped."""
    return {
        name: [
            float(f)
            for f in np.asarray(s.cpu(), dtype=np.float64).mean(axis=(0, 1, 2))
        ]
        for name, s in skips.items()
    }


def run_model(
    name: str,
    x,
    params: Params | None = None,
    *,
    input_size: int | None = None,
    num_classes: int | None = None,
    plan: PartitionPlan | None = None,
    seed: int = 0,
    dtype: str | None = None,
    device=None,
):
    """Convenience one-shot: build the zoo graph, auto-partition, run.

    ``x`` (array-like, NHWC) and freshly initialized params go to
    ``device`` (``None`` = the CUDA card).  ``dtype`` selects the compute
    dtype end to end: the partition is planned at it and the params are cast
    once before the run; the returned master ``params`` stay float32.

    Returns ``(logits, skips, plan, params)``.
    """
    from .graph import MODELS

    dev = resolve_device(device)
    x = torch.as_tensor(x).to(dev)
    kwargs = {}
    if input_size is not None:
        kwargs["input_size"] = input_size
    if num_classes is not None:
        kwargs["num_classes"] = num_classes
    graph = MODELS[name](**kwargs)
    if plan is None:
        plan = auto_partition(graph, batch=x.shape[0], compute_dtype=dtype)
    if params is None:
        params = init_network_params(graph, seed=seed, device=dev)
    prepped = prepare_network_params(plan, params)
    logits, skips = run_network(x, prepped, plan=plan)
    return logits, skips, plan, params
