"""The multi-pod dry run for H100 clusters: trace every (arch x shape x
mesh) cell's step into its per-device graph and record its cost and
memory.

The port of the reference's ``repro.launch.dryrun``, which lowers and
compiles each cell under ``jax.jit`` on 512 placeholder host devices.
Here a cell is traced in one process:

* the production mesh lives on a ``fake`` process group
  (:mod:`repro_torch.launch.mesh`);
* params, optimizer state, batch and caches are DTensors whose local
  shards are fake tensors, placed by the cell's sharding rules
  (:func:`repro_torch.parallel.sharding.rules_for`): nothing is allocated,
  Arctic-480B included;
* the step runs eagerly on them with the ``(mesh, rules)`` pair registered
  for the model's :func:`~repro_torch.parallel.constraints.constrain`
  sites and the planned einsum of :mod:`repro_torch.parallel.spmd`
  installed.  DTensor runs each op on the local fake shards, and the fake
  mode that owns them records every such op into an FX graph
  (:class:`_Recorder`): the rank's program, the counterpart of the
  reference's post-SPMD HLO, with local shapes and ``_c10d_functional``
  collectives.  The train step differentiates inside itself, so its
  backward and update are in the same graph.  (Recording the eager run
  costs about a fifth of what tracing the step under AOTAutograd costs a
  node, and a graph break cannot occur.)

Outputs are given back in the placements their inputs had (the
reference's ``out_shardings``), so a step's resharding is in its graph.
:mod:`repro_torch.launch.graphanalysis` reads the graph's FLOPs,
collectives and a liveness peak; :mod:`repro_torch.launch.roofline`
prices them on the H100.

**Unit depths.**  A recorded op costs about a millisecond, and a 32k
prefill of a 32-layer attention model runs some 10^5 of them.  Every
stack the model runs is homogeneous and pinned per layer by
``constrain``, so a cell's costs are affine in its layer counts (and, in
training, in the microbatches): :func:`fitted_cost` traces the cell at one
and two layers of each kind (:func:`_depth_knobs`, :func:`_affine`);
``full_depth=True`` traces the whole stack instead (the tests hold the two
equal in FLOPs and collectives).  Argument bytes are counted from the
full-depth shards, never fitted; the liveness peak and the traffic proxy
are fitted too and are estimates.

**Memory.**  The liveness walk frees a tensor at its last use, as a
compiler's schedule would, and holds a kernel's own workspace (kernel D's
backward's) while its op runs; PyTorch's eager step holds more (a Python
reference lives to the end of its scope).  On the card the measured peak
came out up to :data:`HBM_MARGIN` times the walk's total (the Mamba-2-780m
train step), so ``fits_hbm`` asks that the total times that margin fit,
and ``total_bytes`` stays the walk's own estimate.

:func:`run_cells` records cells; it traces them in this process, or
spreads every trace of every cell over a pool of worker processes.  The
CLI mirrors the reference's: ``--arch``, ``--shape``, ``--mesh``,
``--out`` (resumable: ``ok`` and ``skipped`` cells are kept), and exit 1
if any cell failed, every failure recorded as ``status: error``;
``--workers N`` traces in N processes.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.h100 import HBM_PER_CHIP
from repro_torch.configs.shapes import ShapeConfig, cell_supported
from repro_torch.launch import graphanalysis as GA
from repro_torch.launch import mesh as MESH
from repro_torch.launch.steps import (
    input_specs,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models.model import build_param_specs
from repro_torch.models.params import tree_map
from repro_torch.models.serving import build_cache_specs
from repro_torch.optim.adamw import AdamWState
from repro_torch.parallel.constraints import mesh_rules
from repro_torch.parallel.spmd import dtensor_einsum
from repro_torch.parallel.sharding import (
    ShardingRules,
    local_shape,
    partition_spec,
    placements,
    rules_for,
)

# microbatch policy: rows-per-device-per-microbatch (activation-memory
# control); default 2 rows, HBM-tight archs drop to 1 row (+ bf16 grad
# accumulation for the 480B MoE).
TRAIN_ROWS_PER_DEVICE = 2
TRAIN_OVERRIDES: dict[str, dict] = {
    "arctic_480b": {"rows": 1, "accum_dtype": "bfloat16"},
    "whisper_large_v3": {"rows": 1},
    "minicpm3_4b": {"rows": 1},
    "qwen2_moe_a2_7b": {"rows": 1},
    "llama32_vision_11b": {"rows": 1},
}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# measured peak / predicted total on one H100 (chip_smoke.py phase plan
# (b)): Mamba-2 prefill 1.27, Hymba 1.30, Qwen 1.18, the Mamba-2 train
# step 1.52 (32.51 GB against 21.36), rounded up; the phase checks that it
# still covers every measured peak
HBM_MARGIN = 1.55


def _arch_key(cfg) -> str:
    return cfg.name.replace("-", "_").replace(".", "_")


def microbatches_for(cfg, shape, sizes: dict[str, int]) -> int:
    """The reference's microbatch count of a train cell on a mesh of
    ``sizes``."""
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    rows = TRAIN_OVERRIDES.get(_arch_key(cfg), {}).get(
        "rows", TRAIN_ROWS_PER_DEVICE)
    return max(1, shape.global_batch // (dp * rows))


# ---------------------------------------------------------------------------
# abstract DTensors
# ---------------------------------------------------------------------------


class _Recorder:
    """Builds the per-rank FX graph of the ops a fake mode runs: one node a
    top-level op on fake tensors, its arguments the nodes that made them
    (a tensor from outside becomes a placeholder), its ``meta["val"]`` the
    fake outputs."""

    def __init__(self):
        self.graph = torch.fx.Graph()
        self.node_of: dict[int, torch.fx.Node] = {}
        self.keep: list = []  # tensors alive, so no id is reused

    def _arg(self, a):
        if isinstance(a, torch.Tensor):
            node = self.node_of.get(id(a))
            if node is None:
                node = self.graph.placeholder(f"in{len(self.keep)}")
                node.meta["val"] = a
                self.node_of[id(a)] = node
                self.keep.append(a)
            return node
        if isinstance(a, (list, tuple)):
            return type(a)(self._arg(x) for x in a)
        if isinstance(a, dict):
            return {k: self._arg(v) for k, v in a.items()}
        return a

    def record(self, func, args, kwargs, out) -> None:
        node = self.graph.call_function(func, self._arg(args),
                                        self._arg(kwargs))
        node.meta["val"] = out
        outs = out if isinstance(out, (list, tuple)) else (out,)
        for i, t in enumerate(outs):
            if isinstance(t, torch.Tensor):
                self.node_of[id(t)] = (node if outs is not out else
                                       self._getitem(node, i, t))
                self.keep.append(t)

    def _getitem(self, node, i, t):
        import operator

        item = self.graph.call_function(operator.getitem, (node, i))
        item.meta["val"] = t
        return item

    def finish(self, outputs) -> torch.fx.Graph:
        self.graph.output(self._arg(list(outputs)))
        return self.graph


def _recording_fake_mode():
    """A ``FakeTensorMode`` that hands every op it runs on fake tensors at
    the top level (not inside its own decompositions) to a
    :class:`_Recorder`.  A DTensor op reaches the mode first with DTensor
    arguments and is passed on; DTensor then runs its local ops on the
    fake shards, and those are what is recorded: the rank's program."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    class RecordingFakeTensorMode(FakeTensorMode):
        def __init__(self):
            super().__init__()
            self.recorder = None
            self.depth = 0
            self.muted = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            self.depth += 1
            try:
                out = super().__torch_dispatch__(func, types, args, kwargs)
            finally:
                self.depth -= 1
            if (self.recorder is not None and self.depth == 0
                    and not self.muted and out is not NotImplemented
                    and isinstance(func, torch._ops.OpOverload)):
                self.recorder.record(func, args, kwargs, out)
            return out

    return RecordingFakeTensorMode()


@contextlib.contextmanager
def _unrecorded_propagation(mode):
    """DTensor computes an op's output shapes by running it on fake
    tensors of the global shapes, in the active fake mode; those runs are
    no device's work and are kept out of the record."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    names = [n for n in vars(ShardingPropagator)
             if n.startswith("_propagate_tensor_meta")]
    saved = {n: getattr(ShardingPropagator, n) for n in names}

    def muted(fn):
        def run(*args, **kwargs):
            mode.muted += 1
            try:
                return fn(*args, **kwargs)
            finally:
                mode.muted -= 1
        return run

    for n, fn in saved.items():
        setattr(ShardingPropagator, n, muted(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ShardingPropagator, n, fn)


class _Abstract:
    """Makes DTensors over ``mesh`` whose local shards are fake tensors of
    one recording fake mode, placed by ``rules``; tallies their local
    bytes."""

    def __init__(self, mesh, rules: ShardingRules):
        self.mesh, self.rules = mesh, rules
        self.mode = _recording_fake_mode()
        self.bytes = 0

    def tensor(self, shape, logical, dtype):
        from torch.distributed.tensor import DTensor

        shape = tuple(int(n) for n in shape)
        spec = partition_spec(shape, tuple(logical), self.mesh, self.rules)
        with self.mode:
            local = torch.empty(local_shape(shape, spec, self.mesh),
                                dtype=dtype)
        self.bytes += local.numel() * local.element_size()
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.mesh,
                                  placements(spec, self.mesh),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)

    def tree(self, specs, dtype):
        return tree_map(lambda s: self.tensor(s.shape, s.axes, dtype), specs)


def _batch_logical(name: str, ndim: int) -> tuple:
    if name == "tokens":
        return ("batch",) + (None,) * (ndim - 1)
    if name in ("vision", "frames"):
        return ("batch", None, None)
    return (None,) * ndim


@contextlib.contextmanager
def _true_alltoall():
    """DTensor moves a shard between tensor dims with an all-to-all, but
    on a CPU mesh it rewrites that into an all-gather and a chunk (the
    gloo group has no all-to-all).  The production mesh stands for H100s,
    so within a trace the op stays ``_dtensor.shard_dim_alltoall``, which
    :mod:`.graphanalysis` prices as the all-to-all it is (its fake
    implementation gives the shapes)."""
    import torch.distributed.tensor.placement_types as pt

    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None:
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        from torch.distributed._functional_collectives import (
            _resolve_group_name,
        )

        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            _resolve_group_name((mesh, mesh_dim)))

    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


_GAPS_REGISTERED = False


def _register_dtensor_gaps() -> None:
    """Sharding rules for the ops of the model that DTensor has none for
    in some torch releases: ``aten._assert_async`` (``F.one_hot``'s range
    check) runs on a replicated flag and returns nothing; ``aten.flip``
    (in ``cumsum``'s backward) keeps any shard of a dim it does not
    flip."""
    global _GAPS_REGISTERED
    if _GAPS_REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten._assert_async.msg)
    def _assert_rule(flag, msg):
        return [([], [Replicate(), None])]

    @register_sharding(torch.ops.aten.flip.default)
    def _flip_rule(x, dims):
        flipped = {d % len(x.shape) for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None]) for d in range(len(x.shape))
            if d not in flipped]

    _GAPS_REGISTERED = True


def _redistribute_like(out, like):
    """``out`` (a tree) with each DTensor leaf in the placements of the
    matching leaf of ``like``."""
    return _map2(lambda o, l: o if tuple(o.placements) == tuple(
        l.placements) else o.redistribute(l.device_mesh, l.placements),
        out, like)


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_map2(fn, x, y) for x, y in zip(a, b)))
    return fn(a, b)


# ---------------------------------------------------------------------------
# one trace
# ---------------------------------------------------------------------------


def _prepare(cfg, shape, mesh, rules, *, microbatches, grad_dtype):
    """``(fn, args, abstract)``: the cell's step closed over its static
    arguments, its DTensor arguments, and their maker (argument bytes)."""
    ab = _Abstract(mesh, rules)
    pspecs = build_param_specs(cfg)
    dt = _DTYPES[cfg.dtype]
    params = ab.tree(pspecs, dt)

    def batch_of(specs):
        return {k: ab.tensor(v.shape, _batch_logical(k, v.dim()), v.dtype)
                for k, v in specs.items()}

    if shape.step == "train":
        ov = TRAIN_OVERRIDES.get(_arch_key(cfg), {})
        accum = _DTYPES[ov.get("accum_dtype", "float32")]
        gd = _DTYPES[grad_dtype] if isinstance(grad_dtype, str) else grad_dtype
        step_fn, opt = make_train_step(cfg, microbatches=microbatches,
                                       accum_dtype=accum, grad_dtype=gd)
        mom = _DTYPES[cfg.moment_dtype]
        opt_state = AdamWState(step=ab.tensor((), (), torch.int32),
                               mu=ab.tree(pspecs, mom),
                               nu=ab.tree(pspecs, mom))
        batch = batch_of(input_specs(cfg, shape))

        def fn(params, opt_state, batch):
            new_p, new_s, loss = step_fn(params, opt_state, batch)
            return (_redistribute_like(new_p, params),
                    _redistribute_like(new_s, opt_state), loss)

        return fn, (params, opt_state, batch), ab
    logits_pl = placements(partition_spec(
        (shape.global_batch, cfg.vocab), ("batch", "vocab"), mesh, rules),
        mesh)
    if shape.step == "prefill":
        step_fn = make_prefill_step(cfg)
        batch = batch_of(input_specs(cfg, shape))

        def fn(params, batch):
            out = step_fn(params, batch)
            return out.redistribute(mesh, logits_pl)

        return fn, (params, batch), ab
    # decode: the token lands in slot 0, which the traced rank holds
    step_fn = make_decode_step(cfg)
    specs = input_specs(cfg, shape)
    tokens = ab.tensor(specs["tokens"].shape, ("batch", None), torch.int32)
    caches = ab.tree(build_cache_specs(cfg, shape.global_batch,
                                       shape.seq_len), dt)

    def fn(params, tokens, caches):
        logits, new = step_fn(params, tokens, caches, 0)
        return (logits.redistribute(mesh, logits_pl),
                _redistribute_like(new, caches))

    return fn, (params, tokens, caches), ab


def trace_cell(cfg, shape, mesh, *, microbatches: int | None = None,
               rules_override: dict | None = None,
               cfg_override: dict | None = None, grad_dtype=None):
    """Trace one (arch x shape x mesh) cell at ``cfg``'s own depth; return
    ``(graphs, meta)``: the per-rank FX graph (one: the steps
    differentiate inside themselves, so nothing breaks it) and
    ``t_trace_s``, ``nodes`` and ``microbatches``."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels.ssd_scan.ssd_scan import register_sharding_rule

    register_sharding_rule()
    _register_dtensor_gaps()
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    rules = rules_for(shape.step, long_context=shape.name == "long_500k")
    if rules_override:
        rules = rules.override(**rules_override)
    mb = microbatches
    if shape.step == "train" and mb is None:
        mb = microbatches_for(cfg, shape, MESH.sizes(mesh))
    fn, args, ab = _prepare(cfg, shape, mesh, rules, microbatches=mb or 1,
                            grad_dtype=grad_dtype)
    rec = _Recorder()
    t0 = time.time()
    with ab.mode, implicit_replication(), mesh_rules(mesh, rules), \
            _true_alltoall(), dtensor_einsum(), \
            _unrecorded_propagation(ab.mode):
        ab.mode.recorder = rec
        try:
            out = fn(*args)
        finally:
            ab.mode.recorder = None
    graph = rec.finish([t.to_local() for t in leaves_of(out)])
    meta = {"t_trace_s": round(time.time() - t0, 2),
            "nodes": len(graph.nodes), "microbatches": mb}
    return [graph], meta


def leaves_of(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_of(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves_of(t)]
    return [tree]


# ---------------------------------------------------------------------------
# unit depths: costs affine in the layer counts and microbatches
# ---------------------------------------------------------------------------


def _depth_knobs(cfg) -> tuple[dict[str, int], object]:
    """``(full, make)``: the cell's layer counts by stack kind, and
    ``make(counts)``, the config override of a model with those counts.
    Every stack is homogeneous: the SSM, dense and MoE families' layers;
    Hymba's global and sliding layers; a VLM's groups (``cross_every - 1``
    self layers and a cross layer); Whisper's decoder and encoder layers."""
    if cfg.family == "hybrid":
        g = len(cfg.global_layers)

        def make(c):
            return {"n_layers": c["global"] + c["sliding"],
                    "global_layers": tuple(range(c["global"]))}

        return {"global": g, "sliding": cfg.n_layers - g}, make
    if cfg.family == "vlm":
        return ({"groups": cfg.n_layers // cfg.cross_every},
                lambda c: {"n_layers": c["groups"] * cfg.cross_every})
    if cfg.kind == "encdec":
        return ({"decoder": cfg.n_layers, "encoder": cfg.enc_layers},
                lambda c: {"n_layers": c["decoder"],
                           "enc_layers": c["encoder"]})
    return {"layers": cfg.n_layers}, lambda c: {"n_layers": c["layers"]}


def cost_dict(graphs, groups) -> dict[str, float]:
    """The quantities a record keeps, of one trace, as a flat dict."""
    c = GA.analyze_graphs(graphs, groups)
    d = {"flops": c.flops, "collective_bytes": c.collective_bytes,
         "traffic_bytes": c.traffic_bytes,
         "n_collectives": float(c.n_collectives),
         "temp_bytes": float(max(GA.peak_live_bytes(g) for g in graphs)),
         "output_bytes": float(sum(GA.output_bytes(g) for g in graphs))}
    d.update({f"by_collective|{k}": v for k, v in c.by_collective.items()})
    d.update({f"by_axes|{k}": v for k, v in c.by_axes.items()})
    return d


def _affine(points: list[tuple[dict, dict]], base: dict, full: dict):
    """Evaluate at ``full`` the function affine in the counts that takes
    the values ``points`` at ``base`` and at ``base`` plus one of each
    count (the first point is ``base``)."""
    keys = {k for _, v in points for k in v}
    at_base = points[0][1]
    out = {}
    for key in keys:
        val = at_base.get(key, 0.0)
        for counts, v in points[1:]:
            (knob,) = [k for k in counts if counts[k] != base[k]]
            val += (v.get(key, 0.0) - at_base.get(key, 0.0)) * (
                full[knob] - base[knob])
        out[key] = val
    return out


def _probe_tasks(cfg, shape, mesh_spec, *, microbatches=None,
                 rules_override=None, grad_dtype=None,
                 full_depth: bool = False):
    """``(tasks, combine, M)``: the picklable traces a cell's cost needs
    (:func:`probe`), the function that turns their costs into the cell's,
    and the cell's microbatches.  Per stack kind the count takes 1 and 2
    (the others 1); a train cell of ``M >= 2`` microbatches is traced at 2 and 3
    microbatches of the same rows, and the costs are affine in ``M`` too.
    ``full_depth`` asks for one trace of the whole stack."""
    full, make = _depth_knobs(cfg)
    M = microbatches
    if shape.step == "train" and M is None:
        M = microbatches_for(cfg, shape, dict(zip(mesh_spec[1],
                                                  mesh_spec[0])))
    common = dict(cfg_fields=_cfg_fields(cfg), mesh=mesh_spec,
                  rules_override=rules_override, grad_dtype=grad_dtype)
    if full_depth:
        task = dict(common, shape=dataclasses.astuple(shape),
                    microbatches=M, cfg_override={})
        return [task], lambda costs: costs[0], M
    base = {k: 1 for k in full}
    points = [dict(base)] + [{**base, k: 2} for k in full]
    ms = [2, 3] if shape.step == "train" and M and M >= 2 else [M]
    tasks = []
    for m in ms:
        sh = shape
        if m is not None and m != M:
            sh = dataclasses.replace(
                shape, global_batch=shape.global_batch // M * m)
        for counts in points:
            tasks.append(dict(common, shape=dataclasses.astuple(sh),
                              microbatches=m, cfg_override=make(counts)))

    def combine(costs):
        n = len(points)
        per_m = [_affine(list(zip(points, costs[i * n:(i + 1) * n])), base,
                         full) for i in range(len(ms))]
        if len(per_m) == 1:
            return per_m[0]
        lo, hi = per_m  # at 2 and 3 microbatches
        return {k: lo.get(k, 0.0) + (hi.get(k, 0.0) - lo.get(k, 0.0))
                * (M - 2) for k in set(lo) | set(hi)}

    return tasks, combine, M


def _cfg_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


_MESHES: dict = {}


def _mesh_for(spec):
    """This process's mesh of ``spec = (shape, names)``; one at a time."""
    if spec not in _MESHES:
        _MESHES.clear()
        _MESHES[spec] = MESH.fake_mesh(*spec)
    return _MESHES[spec]


def probe(task: dict) -> tuple[dict, dict]:
    """One trace of a task of :func:`_probe_tasks` (in this process or a
    worker): ``(cost_dict, meta)``."""
    from repro_torch.configs.base import ArchConfig

    cfg = ArchConfig(**task["cfg_fields"])
    shape = ShapeConfig(*task["shape"])
    mesh = _mesh_for(task["mesh"])
    graphs, meta = trace_cell(cfg, shape, mesh,
                              microbatches=task["microbatches"],
                              rules_override=task["rules_override"],
                              cfg_override=task["cfg_override"],
                              grad_dtype=task["grad_dtype"])
    return cost_dict(graphs, GA.group_axes(mesh)), meta


def mesh_spec(mesh) -> tuple:
    return (tuple(int(mesh.size(i)) for i in range(mesh.ndim)),
            tuple(mesh.mesh_dim_names))


def fitted_cost(cfg, shape, mesh, *, microbatches: int | None = None,
                rules_override=None, grad_dtype=None,
                full_depth: bool = False):
    """The cell's :func:`cost_dict` at full depth, from traces at unit
    depths (or one at full depth) in this process, and a meta dict
    (``probes``, ``nodes``, ``t_trace_s``, ``microbatches``).  Exact when
    the layers of a kind trace alike."""
    tasks, combine, M = _probe_tasks(cfg, shape, mesh_spec(mesh),
                                     microbatches=microbatches,
                                     rules_override=rules_override,
                                     grad_dtype=grad_dtype,
                                     full_depth=full_depth)
    return _combined(_run_here(mesh, tasks), combine, M)


def _run_here(mesh, tasks) -> list:
    """:func:`probe` of each task in this process, on ``mesh``; a failed
    trace gives its exception."""
    _MESHES.clear()
    _MESHES[mesh_spec(mesh)] = mesh
    out = []
    for t in tasks:
        try:
            out.append(probe(t))
        except Exception as e:  # raised or recorded by the caller
            out.append(e)
    return out


def _combined(results, combine, M) -> tuple[dict, dict]:
    """The cell's cost and meta from its traces' results; the first
    failed trace raises."""
    for r in results:
        if isinstance(r, BaseException):
            raise r
    meta = {"probes": len(results),
            "nodes": sum(m["nodes"] for _, m in results),
            "t_trace_s": round(sum(m["t_trace_s"] for _, m in results), 2),
            "microbatches": M}
    return combine([c for c, _ in results]), meta


def argument_bytes(cfg, shape, mesh, *, rules_override=None,
                   microbatches=None) -> int:
    """Local bytes of the cell's arguments at full depth (nothing
    traced)."""
    rules = rules_for(shape.step, long_context=shape.name == "long_500k")
    if rules_override:
        rules = rules.override(**rules_override)
    _, _, ab = _prepare(cfg, shape, mesh, rules,
                        microbatches=microbatches or 1, grad_dtype=None)
    return ab.bytes


def record_of(cost: dict, meta: dict, arg_bytes: int) -> dict:
    """The record keys of a cell's costs (the reference's, with the
    collective bytes also filed by mesh axes)."""
    by_coll = {k.split("|", 1)[1]: v for k, v in cost.items()
               if k.startswith("by_collective|")}
    by_axes = {k.split("|", 1)[1]: v for k, v in cost.items()
               if k.startswith("by_axes|")}
    mem = {"argument_bytes": int(arg_bytes),
           "output_bytes": int(round(cost["output_bytes"])),
           "temp_bytes": int(round(cost["temp_bytes"]))}
    mem["total_bytes"] = mem["argument_bytes"] + mem["temp_bytes"]
    return {
        "microbatches": meta["microbatches"],
        "t_trace_s": meta["t_trace_s"],
        "probes": meta["probes"],
        "nodes": meta["nodes"],
        "memory": mem,
        "hbm_margin": HBM_MARGIN,
        "fits_hbm": bool(mem["total_bytes"] * HBM_MARGIN < HBM_PER_CHIP),
        "hlo": {
            "flops_per_device": cost["flops"],
            "collective_bytes_per_device": cost["collective_bytes"],
            "collective_bytes_by_axes": {k: round(v) for k, v in
                                         sorted(by_axes.items())},
            "traffic_bytes_per_device": cost["traffic_bytes"],
            "n_collectives": int(round(cost["n_collectives"])),
            "by_collective": {k: round(v) for k, v in sorted(
                by_coll.items(), key=lambda kv: -kv[1])},
        },
    }


def cell_record(arch: str, shape_name: str, shape: ShapeConfig, mesh,
                mesh_name: str) -> dict:
    """The keys that name a cell's record."""
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "mesh_sizes": MESH.sizes(mesh), "chips": MESH.chips(mesh),
            "step": shape.step, "seq_len": shape.seq_len,
            "global_batch": shape.global_batch}


def run_cells(cells, mesh, mesh_name: str, pool=None, *,
              analyze: bool = True) -> list[dict]:
    """The records of ``cells`` (:func:`start_cells`), traced on ``mesh``
    in this process or over ``pool``'s workers."""
    return finish_cells(start_cells(cells, mesh_spec(mesh), pool), mesh,
                        mesh_name, analyze=analyze)


def start_cells(cells, spec, pool=None):
    """Start the traces of ``cells`` on the mesh ``spec``; with ``pool``
    (a ``multiprocessing`` pool) they are submitted to its workers without
    waiting, else :func:`finish_cells` runs them in this process.  A cell
    is ``(arch, shape_name[, shape[, opts]])``: ``shape`` replaces the
    named shape's sizes, ``opts`` may set ``microbatches`` and
    ``full_depth``."""
    jobs, flat = [], []
    for cell in cells:
        arch, shape_name = cell[0], cell[1]
        cfg = get_config(arch)
        shape = cell[2] if len(cell) > 2 and cell[2] else SHAPES[shape_name]
        opts = cell[3] if len(cell) > 3 else {}
        depth = opts.get("full_depth", False)
        ok, why = cell_supported(cfg, shape)
        job = {"arch": arch, "shape_name": shape_name, "cfg": cfg,
               "shape": shape, "skip": None if ok else why, "depth": depth}
        if ok:
            job["tasks"], job["combine"], job["M"] = _probe_tasks(
                cfg, shape, spec, microbatches=opts.get("microbatches"),
                full_depth=depth)
            flat += job["tasks"]
        jobs.append(job)
    if pool is None:
        return jobs, lambda mesh: _run_here(mesh, flat)
    result = pool.map_async(_probe_or_error, flat, chunksize=1)
    return jobs, lambda mesh: result.get()


def finish_cells(started, mesh, mesh_name: str, *,
                 analyze: bool = True) -> list[dict]:
    """The records of :func:`start_cells`' cells once their traces are
    done; ``mesh`` is the mesh of their ``spec``.  A cell's ``status`` is
    ok, skipped (with its reason) or error (a failed trace, with its
    reason); ``analyze`` keeps ``hlo`` (the reference's key, so that
    :func:`repro_torch.launch.roofline.analyze_record` reads both
    packages' records)."""
    jobs, results = started
    it = iter(results(mesh))
    recs = []
    for job in jobs:
        rec = cell_record(job["arch"], job["shape_name"], job["shape"], mesh,
                          mesh_name)
        recs.append(rec)
        if job["skip"] is not None:
            rec.update(status="skipped", reason=job["skip"])
            continue
        got = [next(it) for _ in job["tasks"]]
        try:  # a failed cell is a bug; record it and keep going
            cost, meta = _combined(got, job["combine"], job["M"])
            arg = argument_bytes(job["cfg"], job["shape"], mesh,
                                 microbatches=meta["microbatches"])
            body = record_of(cost, meta, arg)
            body["depth"] = "full" if job["depth"] else "fit"
            if not analyze:
                body.pop("hlo")
            rec.update(body, status="ok")
        except Exception as e:
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       trace="".join(traceback.format_exception(e))[-2000:])
    return recs


def _probe_or_error(task):
    try:
        return probe(task)
    except Exception as e:  # carried back to finish_cells and recorded there
        return RuntimeError(f"{type(e).__name__}: {e}\n"
                            + traceback.format_exc()[-1500:])


def _pool(workers: int):
    """A pool of ``workers`` fresh (spawned) processes for :func:`probe`."""
    import multiprocessing

    return multiprocessing.get_context("spawn").Pool(workers)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry run (H100)")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--no-analyze", action="store_true")
    ap.add_argument("--workers", type=int, default=1,
                    help="trace in this many worker processes")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(False)
    if args.mesh in ("multi", "both"):
        meshes.append(True)

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = []
    if out_path.exists():
        results = json.loads(out_path.read_text())
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") in ("ok", "skipped")}

    pool = _pool(args.workers) if args.workers > 1 else None
    try:
        for multi in meshes:
            mesh_name = MESH.mesh_name(multi_pod=multi)
            todo = [(a, s) for a in archs for s in shapes
                    if (a, s, mesh_name) not in done]
            if not todo:
                continue
            mesh = MESH.make_production_mesh(multi_pod=multi)
            # in this process a cell at a time, so each is saved when done
            batches = ([todo] if pool is not None
                       else [[cell] for cell in todo])
            for batch in batches:
                t0 = time.time()
                recs = run_cells(batch, mesh, mesh_name, pool,
                                 analyze=not args.no_analyze)
                for rec in recs:
                    rec["t_total_s"] = round(time.time() - t0, 1)
                    key = (rec["arch"], rec["shape"], rec["mesh"])
                    results = [r for r in results
                               if (r["arch"], r["shape"], r["mesh"]) != key]
                    results.append(rec)
                    mem = rec.get("memory", {}).get("total_bytes", 0) / 2**30
                    print(f"[{mesh_name}] {rec['arch']:20s} "
                          f"{rec['shape']:12s} {rec['status']:8s} "
                          f"mem/dev={mem:6.2f}GiB "
                          f"fits={rec.get('fits_hbm', '-')} "
                          f"t={rec['t_total_s']}s", flush=True)
                out_path.write_text(json.dumps(results, indent=1))
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped (recorded), {n_err} errors")
    if n_err:
        for r in results:
            if r["status"] == "error":
                print(f"  ERROR {r['arch']} {r['shape']} {r['mesh']}:"
                      f" {r['error']}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
