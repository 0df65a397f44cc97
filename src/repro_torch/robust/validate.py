"""Preflight validation: reject a bad request before any kernel launch.

The port of the reference's ``repro.robust.validate``, with the same error
types and the same ``context`` keys.  ``run_network`` assumes its inputs
are exactly what the plan was built for; when they are not, the failure is
a shape error deep inside the kernel wrapper — far from the mistake.  The
:func:`preflight` pass re-checks the whole contract up front and raises the
typed errors of :mod:`repro_torch.robust.errors`, each naming the offending
node or launch:

* **structure** — input rank/spatial/channel agreement with the graph, the
  plan covering real conv/pool nodes of its own graph;
* **params** — every conv/dense node has a ``(w, b)`` pair of the right
  shape; pre-flattened streamed-weight arrays (``"_flat/..."``) match their
  pyramid's level weight counts and the run dtype, and are absent for
  non-streamed pyramids;
* **dtype** — the requested compute dtype is known *and* executable
  (``EXEC_DTYPES``: int8 is modeled-only and must fail here);
* **numerics** — all params finite (:class:`NumericError` listing the
  poisoned nodes);
* **budget** — every planned launch fits the plan's budget at the
  request's batch (:class:`BudgetError` naming the launch and the budget's
  model; the degradation ladder answers this rung by replanning).  The
  budget is the plan's own: the card's
  (:data:`~repro_torch.core.program.CARD_BUDGET`) unless the plan was made
  under the reference's TPU budget.

The finiteness checks run on the params' device and come to the host in
one copy per device.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.core.dtypes import EXEC_DTYPES, canonical_dtype, torch_dtype

from .errors import BudgetError, NumericError, PreflightError

# key prefix of pre-flattened streamed-weight arrays (mirrors net/runner)
_FLAT = "_flat/"


def _resolve_dtype(plan, dtype) -> str:
    try:
        cdt = canonical_dtype(plan.compute_dtype if dtype is None else dtype)
    except KeyError as e:
        raise PreflightError(
            f"unknown compute dtype: {e.args[0]}", dtype=str(dtype)
        ) from e
    if cdt not in EXEC_DTYPES:
        raise PreflightError(
            f"compute dtype {cdt!r} is modeled but not executable; the fused"
            f" kernels run {EXEC_DTYPES} (int8 needs the quantized-pyramid"
            " epilogue — see ROADMAP)",
            dtype=cdt,
        )
    return cdt


def _check_input(x, graph) -> None:
    # every rejection names the offending field machine-readably: serving
    # callers surface ``err.context["field"]`` to the client
    if getattr(x, "ndim", None) != 4:
        raise PreflightError(
            f"input must be a (B, H, W, C) batch, got shape"
            f" {tuple(getattr(x, 'shape', ())) or None}",
            graph=graph.name, field="rank",
        )
    b, h, w, c = x.shape
    if b < 1:
        raise PreflightError(
            "input batch is empty", graph=graph.name, field="batch",
        )
    if h != graph.input_size or w != graph.input_size:
        raise PreflightError(
            f"input spatial dims {h}x{w} do not match graph"
            f" {graph.name}'s {graph.input_size}x{graph.input_size}",
            graph=graph.name, field="spatial",
        )
    if c != graph.in_channels:
        raise PreflightError(
            f"input has {c} channels, graph {graph.name} expects"
            f" {graph.in_channels}",
            graph=graph.name, field="channels",
        )


def _fits_f32(arr: np.ndarray) -> bool:
    """Do all (finite) wide-float values survive the cast to float32?"""
    with np.errstate(over="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return bool(np.isfinite(arr.astype(np.float32)).all())


def check_request(x, graph, *, require_finite: bool = True) -> None:
    """Admission-time validation of one serving request against a graph.

    The per-request subset of :func:`preflight`: shape agreement with the
    graph and (``require_finite``) input finiteness — the two properties a
    queued request can individually violate.  ``x`` is a host array
    (anything ``numpy.asarray`` takes, a CPU tensor included): admission
    runs per request on the host, before any device copy.  Raises
    :class:`PreflightError` on shape/dtype problems and
    :class:`NumericError` on NaN/Inf pixels (or float64 values that
    overflow the float32 compute dtype).  Every rejection's ``context``
    carries a ``field`` key naming the offending property (``rank`` /
    ``batch`` / ``spatial`` / ``channels`` / ``dtype`` / ``values`` /
    ``range``).
    """
    _check_input(x, graph)
    if not require_finite:
        return
    # scan in the native dtype first so an f64 request with NaN/Inf pixels
    # is named as non-finite (field="values"), not as an f32 cast artifact
    arr = np.asarray(x)
    if arr.dtype == object or not (
        np.issubdtype(arr.dtype, np.floating)
        or np.issubdtype(arr.dtype, np.integer)
        or np.issubdtype(arr.dtype, np.bool_)
    ):
        raise PreflightError(
            f"request input dtype {arr.dtype} is not numeric"
            f" (graph {graph.name})",
            graph=graph.name, field="dtype",
        )
    if np.issubdtype(arr.dtype, np.floating):
        if not np.isfinite(arr).all():
            raise NumericError(
                f"request input carries non-finite values"
                f" (graph {graph.name})",
                graph=graph.name, field="values",
            )
        if arr.dtype.itemsize > 4 and not _fits_f32(arr):
            # finite in f64 but overflows the f32 the kernels compute in
            raise NumericError(
                f"request input is finite in {arr.dtype} but overflows"
                f" float32, the serving compute dtype"
                f" (graph {graph.name})",
                graph=graph.name, field="range",
            )


def _check_plan_structure(plan) -> None:
    graph = plan.graph
    names = {n.name for n in graph.nodes}
    for pyr in plan.pyramids:
        for nm in pyr.node_names:
            if nm not in names:
                raise PreflightError(
                    f"plan pyramid {pyr.name} covers node {nm!r} which is not"
                    f" in graph {graph.name}",
                    launch=pyr.name,
                )
            op = graph.node(nm).op
            if op not in ("conv", "pool"):
                raise PreflightError(
                    f"plan pyramid {pyr.name} covers node {nm!r} of op"
                    f" {op!r}; pyramids fuse conv/pool chains only",
                    launch=pyr.name, node=nm,
                )


def _check_params(params, plan, cdt: str) -> None:
    from repro_torch.net.graph import infer_shapes

    graph = plan.graph
    shapes = infer_shapes(graph)
    tdt = torch_dtype(cdt)
    for n in graph.nodes:
        if n.op not in ("conv", "dense"):
            continue
        if n.name not in params:
            raise PreflightError(
                f"missing params for node {n.name!r} of graph {graph.name}",
                node=n.name,
            )
        w, b = params[n.name]
        c_in = shapes[n.inputs[0]].channels
        want_w = (n.K, n.K, c_in, n.n_out) if n.op == "conv" else (c_in, n.n_out)
        if tuple(w.shape) != want_w:
            raise PreflightError(
                f"node {n.name!r}: weight shape {tuple(w.shape)} does not"
                f" match the graph's {want_w}",
                node=n.name,
            )
        if tuple(b.shape) != (n.n_out,):
            raise PreflightError(
                f"node {n.name!r}: bias shape {tuple(b.shape)} does not match"
                f" ({n.n_out},)",
                node=n.name,
            )
        if not (w.is_floating_point() and b.is_floating_point()):
            raise PreflightError(
                f"node {n.name!r}: params must be floating"
                f" (got {w.dtype}/{b.dtype}); integer params need the"
                " quantized path",
                node=n.name,
            )
    covered_flats = set()
    for pyr in plan.pyramids:
        key = _FLAT + pyr.name
        covered_flats.add(key)
        flat = params.get(key)
        if flat is None:
            continue  # runner falls back to per-level tensors
        if not pyr.launch.streamed:
            raise PreflightError(
                f"pre-flattened weights {key!r} present but pyramid"
                f" {pyr.name} is not streamed — the resident kernel reads"
                " per-level tensors; re-prepare with the current plan",
                launch=pyr.name,
            )
        if flat.dtype != tdt:
            raise PreflightError(
                f"pre-flattened weights {key!r} are {flat.dtype} but the run"
                f" computes {cdt}; params were prepared at a different dtype"
                " — re-run prepare_network_params at the run dtype",
                launch=pyr.name, dtype=cdt,
            )
        want = sum(pyr.launch.program.level_weight_counts())
        if flat.numel() != want:
            raise PreflightError(
                f"pre-flattened weights {key!r} hold {flat.numel()} values,"
                f" launch program expects {want}; params were prepared for a"
                " different plan",
                launch=pyr.name,
            )
    stale = [
        k for k in params
        if k.startswith(_FLAT) and k not in covered_flats
    ]
    if stale:
        raise PreflightError(
            f"params carry pre-flattened weights for pyramids not in this"
            f" plan: {sorted(stale)}; re-prepare with the current plan",
            launch=stale[0][len(_FLAT):],
        )


def nonfinite_param_nodes(params) -> list[str]:
    """Names of param entries (nodes and ``"_flat/..."`` arrays) carrying
    any non-finite value — the preflight numeric check, exposed so the
    healing rung can name what it reloads.  One all-finite reduction per
    entry on its device, read on the host in one copy per device."""
    flags: dict[torch.device, list] = {}
    for key, val in params.items():
        arrs = (val,) if key.startswith(_FLAT) else val
        for arr in arrs:
            flags.setdefault(arr.device, []).append(
                (key, torch.isfinite(arr).all())
            )
    bad = set()
    for entries in flags.values():
        ok = torch.stack([f for _, f in entries]).tolist()
        bad.update(key for (key, _), fine in zip(entries, ok) if not fine)
    return [key for key in params if key in bad]


def _check_budget(plan, budget, batch: int) -> None:
    over = [
        (p.name, budget.working_set(p.launch, batch))
        for p in plan.pyramids
        if not budget.fits(p.launch, batch)
    ]
    if over:
        name, need = over[0]
        raise BudgetError(
            f"{len(over)} planned launch(es) exceed the {budget}"
            f" at batch {batch}; first: {name} needs {need} bytes",
            launch=name, **budget.context(need),
        )


def preflight(
    x,
    params,
    *,
    plan,
    dtype: str | None = None,
    budget=None,
    check_budget: bool = True,
) -> str:
    """Validate a ``run_network`` request end to end; returns the resolved
    canonical compute dtype.

    Raises :class:`PreflightError` on structural/dtype problems,
    :class:`NumericError` (with ``context['nodes']``) on non-finite params,
    and :class:`BudgetError` when a planned launch no longer fits
    ``budget`` (a :class:`~repro_torch.core.program.Budget`; default: the
    plan's own) at the batch of ``x``.  The checks run in
    that order so the most actionable error surfaces first.
    """
    cdt = _resolve_dtype(plan, dtype)
    _check_input(x, plan.graph)
    _check_plan_structure(plan)
    _check_params(params, plan, cdt)
    bad = nonfinite_param_nodes(params)
    if bad:
        raise NumericError(
            f"non-finite values in params of {len(bad)} node(s):"
            f" {sorted(bad)}",
            nodes=sorted(bad),
        )
    if check_budget:
        _check_budget(plan, plan.budget if budget is None else budget,
                      int(x.shape[0]))
    return cdt
