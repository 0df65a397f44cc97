"""One run of one cell: set-up, the measured window, the readers and the
comparison that decides ``correct``.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration's file, its traffic mix
(``cardbench/traffic/<traffic>.json``), its own numbers
(``cardbench/workloads/<cell>.json``: buckets, rate, the limit of the
comparison) and one reader a metric (``cardbench/end_to_end/<name>.py``,
``cardbench/metrics/<name>.py``), each with a ``read(run)`` that returns a
number or None.

The program under test is ``repro_torch``'s serving path, driven through
its public entry points only: ``ServingFrontend.submit`` over a
``ServingEngine`` built from ``ServeConfig`` defaults but for the cell's
buckets, with the benchmark's weights.  From the program the run reads the
engine's ``summary()`` counters and ``repro_torch.kernels.build``'s launch
counts; nothing of the program's own tracing runs.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import queue
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from cardbench.reference import cnn
from cardbench.traffic.generator import ClosedRequests

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
RESULT_WAIT_S = 60.0  # how long past the window's close a request may take
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (0.0 where it
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def quarters(done_s, rows, latency_s, t0: float, seconds: float) -> list:
    """Per quarter of the window: images answered a second and the p95
    latency in ms of the requests sent in it (a view of drift)."""
    out = []
    q = seconds / 4
    for k in range(4):
        lo, hi = t0 + k * q, t0 + (k + 1) * q
        n = sum(r for d, r in zip(done_s, rows) if lo <= d < hi)
        out.append(round(n / q, 1))
    sent = np.linspace(0, len(latency_s), 5).astype(int)
    p95 = [float(np.percentile(latency_s[a:b], 95) * 1e3) if b > a else None
           for a, b in zip(sent[:-1], sent[1:])]
    return list(zip(out, p95))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# finding a cell
# ---------------------------------------------------------------------------


@dataclass
class Cell:
    name: str
    cfg: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; raises
    KeyError for a name the file does not have."""
    bench = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [
        m for m in bench["per_layer"]
        if (name in m["workloads"] if "workloads" in m
            else m["moves"] in reported)
    ]
    return Cell(
        name=name,
        cfg=_json(ROOT / conf["file"]),
        traffic=_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        workload=_json(BENCH / "workloads" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def load_reader(kind: str, name: str):
    """``read`` of ``cardbench/<kind>/<name>.py``."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench_{kind}_{name.replace('.', '_')}", path
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ---------------------------------------------------------------------------
# inputs and weights, from the seed
# ---------------------------------------------------------------------------


def seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 63-bit seeds derived from the run's ``--seed``."""
    state = np.random.SeedSequence(seed & (2**64 - 1)).generate_state(
        n, np.uint64
    )
    return [int(s) >> 1 for s in state]


def make_params(cfg: dict, seed: int, device) -> dict:
    """He-normal weights and small normal biases of every conv and dense
    layer, in the reference's layout, drawn on ``device`` in one call."""
    leaves = cnn.weight_leaves(cfg)
    total = sum(math.prod(shape) + shape[-1] for _, shape, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    params, off = {}, 0
    with torch.no_grad():
        for name, shape, fan_in in leaves:
            n = math.prod(shape)
            w = flat[off:off + n].view(shape).mul_((2.0 / fan_in) ** 0.5)
            off += n
            b = flat[off:off + shape[-1]].mul_(0.01)
            off += shape[-1]
            params[name] = (w, b)
    return params


def make_pool(cfg: dict, n: int, seed: int, device) -> np.ndarray:
    """``n`` standard-normal NHWC float32 images, drawn on ``device`` and
    brought to the host, where requests are made."""
    size, ch = cfg["input_size"], cfg["in_channels"]
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, size, size, ch), generator=gen, device=device)
    return x.cpu().numpy()


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------


def port_graph(cfg: dict):
    """The program's graph of the configuration, checked layer by layer
    against the configuration's table so that the weights mean the same on
    both sides."""
    from repro_torch.net.graph import MODELS

    graph = MODELS[cfg["port_model"]](
        input_size=cfg["input_size"], num_classes=cfg["layers"][-1]["out"]
    )
    ops = {"conv": "conv", "maxpool": "pool", "dense": "dense"}
    table = [(ops[lay["op"]], lay["name"], lay.get("k", 0), lay.get("s", 1),
              lay.get("pad", 0), lay.get("out", 0), lay.get("relu", True))
             for lay in cfg["layers"] if lay["op"] in ops]
    nodes = [(n.op, n.name, n.K, n.S, n.pad, n.n_out, n.relu)
             for n in graph.nodes if n.op in ("conv", "pool", "dense")]
    norm = [(o, nm, k, s, p, out if o != "pool" else 0,
             r if o != "pool" else True) for o, nm, k, s, p, out, r in nodes]
    if norm != table:
        raise ValueError(
            f"the program's {graph.name} differs from {cfg['name']}'s table"
        )
    if graph.compute_dtype != cfg["compute_dtype"]:
        raise ValueError(f"the program computes {graph.compute_dtype}")
    return graph


class Served:
    """The serving engine and its front end, with the run's listener that
    stamps each request's completion on the host clock."""

    def __init__(self, cfg: dict, params: dict, buckets, device) -> None:
        from repro_torch.net.frontend import ServingFrontend
        from repro_torch.net.serve import ServeConfig, ServingEngine

        self.buckets = tuple(buckets)
        self.engine = ServingEngine(
            port_graph(cfg), params, ServeConfig(buckets=self.buckets),
            device=device,
        )
        self.done_s: dict[int, float] = {}
        self.completions: queue.SimpleQueue | None = None
        self.engine.add_listener(self._on_result)
        self.frontend = ServingFrontend(self.engine)

    def _on_result(self, result) -> None:
        self.done_s[result.id] = time.perf_counter()
        if self.completions is not None:
            self.completions.put(result.id)

    def warm(self, pool: np.ndarray) -> None:
        """Every bucket planned, captured and replayed; the largest one
        twice at once, so the staging's two pinned buffers exist; then the
        front end's thread."""
        eng = self.engine
        for b in self.buckets:
            for _ in range(3):
                eng.submit(pool[:b])
                eng.drain()
        top = self.buckets[-1]
        for _ in range(3):
            eng.submit(pool[:top])
        eng.drain()
        bad = [r for r in eng.results.values() if not r.ok]
        if bad:
            raise RuntimeError(f"warm-up failed: {bad[0].error}")
        self.frontend.start()
        for b in self.buckets:
            result = self.frontend.submit(pool[:b]).result(RESULT_WAIT_S)
            if not result.ok:
                raise RuntimeError(f"warm-up failed: {result.error}")

    def counters(self) -> dict:
        from repro_torch.kernels import build

        per = {}
        for row in self.engine.summary()["buckets"]:
            wall = row["images"] / row["imgs_per_s"] if row["imgs_per_s"] else 0.0
            per[row["bucket"]] = (row["batches"], row["images"], wall)
        return {"buckets": per,
                "launches": {k.symbol: k.launches for k in build.KERNELS}}

    def close(self) -> None:
        from repro_torch.net.runner import clear_compiled_cache

        self.frontend.stop()
        del self.frontend, self.engine
        clear_compiled_cache()
        gc.collect()


def counter_delta(before: dict, after: dict) -> dict:
    buckets = {}
    for b, (n, imgs, wall) in after["buckets"].items():
        n0, i0, w0 = before["buckets"].get(b, (0, 0, 0.0))
        if n > n0:
            buckets[b] = {"batches": n - n0, "images": imgs - i0,
                          "wall_s": wall - w0}
    launches = {k: v - before["launches"].get(k, 0)
                for k, v in after["launches"].items()}
    return {"buckets": buckets, "launches": launches}


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


@dataclass
class Requests:
    """The window's requests: their pool images, when their callers sent
    them, and the handles their answers come back on."""

    rows: list = field(default_factory=list)
    start: list = field(default_factory=list)
    sent_s: list = field(default_factory=list)
    handles: list = field(default_factory=list)


def drive_closed(served: Served, pool, gen: ClosedRequests, close: float,
                 span) -> Requests:
    reqs = Requests()
    done = served.completions = queue.SimpleQueue()
    caller = {}

    def send(c: int) -> None:
        rows, start = gen.next()
        with span("cardbench.submit"):
            h = served.frontend.submit(pool[start:start + rows])
        caller[h.id] = c
        reqs.sent_s.append(time.perf_counter())
        reqs.rows.append(rows)
        reqs.start.append(start)
        reqs.handles.append(h)

    for c in range(gen.clients):
        send(c)
    busy = gen.clients
    while busy:
        try:
            with span("cardbench.result_wait"):
                rid = done.get(timeout=max(close + RESULT_WAIT_S
                                           - time.perf_counter(), 1e-3))
        except queue.Empty:
            break
        c = caller.pop(rid, None)
        if c is None:
            continue
        if time.perf_counter() < close:
            send(c)
        else:
            busy -= 1
    served.completions = None
    return reqs


def collect(served: Served, reqs: Requests, close: float, span):
    """Each request's result (None for one that never came) and latency in
    seconds from its send time (inf for one that failed or never came)."""
    results, latency = [], []
    with span("cardbench.result_wait"):
        for h, sent in zip(reqs.handles, reqs.sent_s):
            left = close + RESULT_WAIT_S - time.perf_counter()
            try:
                r = h.result(max(left, 1e-3))
            except TimeoutError:
                r = None
            results.append(r)
            ok = r is not None and r.ok
            latency.append(served.done_s[h.id] - sent if ok else math.inf)
    return results, np.array(latency)


# ---------------------------------------------------------------------------
# the comparison that decides ``correct``
# ---------------------------------------------------------------------------


def reference_logits(cfg, params, pool, device, precision="float32",
                     block: int = 32) -> np.ndarray:
    out = []
    for i in range(0, len(pool), block):
        x = torch.from_numpy(pool[i:i + block]).to(device)
        out.append(cnn.forward(cfg, params, x, precision).cpu().numpy())
    return np.concatenate(out)


def row_errors(served: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per row: the largest gap between a served logit and the
    reference's, over the reference's largest logit magnitude."""
    with np.errstate(invalid="ignore", divide="ignore"):
        err = (np.abs(served.astype(np.float64) - ref).max(axis=1)
               / np.abs(ref.astype(np.float64)).max(axis=1))
    return np.where(np.isfinite(err), err, np.inf)


def worst_error(results, reqs: Requests, ref: np.ndarray) -> float:
    """The largest row error over every answered request of the window."""
    worst = 0.0
    for r, start, rows in zip(results, reqs.start, reqs.rows):
        if r is not None and r.ok:
            err = row_errors(r.logits, ref[start:start + rows])
            worst = max(worst, float(err.max()))
    return worst


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------


@dataclass
class Run:
    """What the readers read."""

    cell: Cell
    seconds: float
    setup_s: float
    latency_s: np.ndarray  # per request of the window
    completed_in_window: int  # images answered before the window closed
    delta: dict  # counter_delta over the window's requests
    trace: object = None  # cardbench.trace.Trace in a traced run


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", input_size: int | None = None,
             started: float | None = None, age0: float = 0.0,
             early: dict | None = None, control: bool = False,
             log=print) -> dict:
    """One run of cell ``name``; returns the result line's object.

    ``input_size`` shrinks the images (the CPU dry run of the tests);
    ``started``/``age0`` are the host clock at the entry's first line and
    the process's age then; ``early`` holds the seconds of the entry's own
    stages before this call, which the stderr split of set-up lists first.
    ``control`` also computes the reference at TF32 and reports its
    comparison (never in the benchmark's own runs)."""
    started = time.perf_counter() if started is None else started
    cell = find_cell(name)
    cfg = dict(cell.cfg)
    if input_size is not None:
        cfg["input_size"] = input_size
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    marks = dict(early or {})
    marks["to_run"] = round(age0 + time.perf_counter() - started
                            - sum(marks.values()), 3)

    def mark(what: str) -> None:
        if on_card:
            torch.cuda.synchronize()
        marks[what] = round(age0 + time.perf_counter() - started
                            - sum(marks.values()), 3)

    s_weights, s_images, s_traffic = seeds(seed, 3)
    params = make_params(cfg, s_weights, dev)
    mark("weights")
    pool = make_pool(cfg, cell.traffic["pool_images"], s_images, dev)
    mark("images")
    rng = np.random.default_rng(s_traffic)
    served = Served(cfg, params, cell.workload["buckets"], dev)
    served.warm(pool)
    mark("engine_and_warm_up")
    gen = ClosedRequests(cell.traffic, rng)
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    before = served.counters()
    mark("gc_and_counters")
    span = lambda _name: contextlib.nullcontext()  # noqa: E731
    prof = None
    if trace and on_card:
        from torch.profiler import ProfilerActivity, profile, record_function

        span = record_function
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    setup_s = age0 + time.perf_counter() - started

    with span("cardbench.window"):
        t0 = time.perf_counter()
        close = t0 + seconds
        reqs = drive_closed(served, pool, gen, close, span)
        results, latency = collect(served, reqs, close, span)
    if prof is not None:
        if on_card:
            torch.cuda.synchronize()
        prof.stop()
    after = served.counters()
    gc.unfreeze()
    rows = np.array(reqs.rows)
    done_in = [
        r is not None and r.ok and served.done_s[h.id] <= close
        for r, h in zip(results, reqs.handles)
    ]
    run = Run(
        cell=cell, seconds=seconds, setup_s=setup_s, latency_s=latency,
        completed_in_window=int(rows[np.array(done_in, bool)].sum())
        if len(rows) else 0,
        delta=counter_delta(before, after),
    )
    device_info = None
    if on_card:
        device_info = {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
        }
    if prof is not None:
        from cardbench import trace as tr

        run.trace = tr.reduce(prof.events())
        del prof
        if run.trace is not None:
            device_info["busy_s"] = run.trace.busy_s
            device_info["window_s"] = run.trace.window_s
    served_done = served.done_s
    served.close()
    del served
    if on_card:
        torch.cuda.empty_cache()

    metrics = {}
    if on_card:
        for m in (cell.per_layer if trace else cell.end_to_end):
            kind = "metrics" if trace else "end_to_end"
            value = load_reader(kind, m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    ref = reference_logits(cfg, params, pool, dev)
    unanswered = sum(1 for r in results if r is None or not r.ok)
    err = worst_error(results, reqs, ref)
    limit = cell.workload["logit_rel_err_limit"]
    checks = {
        "unanswered": {"value": unanswered, "limit": 0},
        "logit_rel_err": {"value": err, "limit": limit},
    }
    out = {
        "correct": bool(len(results) > 0 and unanswered == 0
                        and err <= limit),
        "attempted": len(results),
        "failed": unanswered,
        "metrics": metrics,
    }
    if control:
        low = reference_logits(cfg, params, pool, dev, "tf32")
        out["control"] = max(
            (float(row_errors(low[s:s + r], ref[s:s + r]).max())
             for s, r in zip(reqs.start, reqs.rows)), default=0.0
        )
    if device_info is not None:
        out["device"] = device_info
        if run.trace is not None:
            out["breakdown"] = run.trace.breakdown()
    log(f"power limit: {_power_limit() if on_card else 'no card'};"
        f" requests {len(results)}, images {int(rows.sum())}")
    done = [served_done.get(h.id, math.inf) for h in reqs.handles]
    log(f"set-up s: {marks};"
        f" quarters (images/s answered, p95 ms of those sent):"
        f" {quarters(done, reqs.rows, latency, t0, seconds)}")
    for key, c in checks.items():
        log(f"check {key}: {c['value']} (limit {c['limit']})")
    out["checks"] = checks
    return out
