#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Run from the root of a checkout on a machine with one H100 and nvcc:

    python3 chip_smoke.py [--out FILE.json]

The main path is the paper's contribution, a CNN forward through fused conv
pyramids: the zoo graph (``repro_torch.net.graph``), the auto-partitioner's
cuts (``repro_torch.net.partition.auto_partition``) and the plan-driven
``repro_torch.net.runner.run_network``, one hand-written CUDA pyramid kernel
launch per pyramid.  The second path is the paper's other half, the
digit-serial sum of products with Early Negative Detection
(``repro_torch.kernels.online_sop.online_sop_end``) on VGG-16's first two
conv layers.  Phases, any failure exits non-zero:

1. build  — compile every kernel of both paths from ``src/repro_torch/csrc``
   (one nvcc per source, started together); print the card's name and
   power limit, torch, CUDA and nvcc versions.
2. pyramids — for every pyramid of the four plans below, the kernel against
   its plain PyTorch version on the card, on dense inputs and on sparse
   ones with negative-shifted biases (the END cascade): skip maps must be
   equal and outputs within the tolerance stated at ``_tol``.  Each dense
   pyramid is also timed (the bare kernel, the wrapper call, the plain
   version, a cuDNN chain) and bounded.
3. end to end — ``run_network`` at full width (224x224 input, 1000
   classes) for ResNet-18 f32 batch 1 and 8, ResNet-18 bf16 batch 8 and
   VGG-16 f32 batch 1, each held against the port's ``reference_network``
   on the card (f32 within ``_tol``, bf16 within ``bf16_logit_tol``), with
   every kernel's launch count reset just before each forward and checked
   just after against that forward's plan.
4. sop — the windows of VGG-16 ``CONV1`` (of the VGG image above) and
   ``CONV2`` (of ``relu(CONV1)``) at 224², P = 50,176 each, scaled by one
   power of two into (-1, 1), through ``online_sop_end`` once per filter
   (64 per layer, 16 digits), with the launch counts reset just before and
   checked just after (128, all through the kernel).  Checked: ``sop``
   times the scale equals the layer's pre-bias convolution; the kernel
   equals its plain version (``sop`` within 1e-5 relative, cycles and
   flags equal except at printed near-ties, see ``latch_disagreements``);
   no flagged row has ``sop >= 0``.  Every filter's launch is timed, and
   every filter's plain version as it is checked; per-layer END shares are
   printed beside the paper's Fig. 12.
5. results — one ``{"kernels": [...]}`` line (for the pyramid kernels
   ``launches`` sums the four forwards, ``launches_per_forward`` splits
   it, and every time sums the per-launch medians over the dense pyramids
   of the four plans; for the SOP kernel ``launches_per_layer`` splits
   the 128 and every time is measured over all 128 launches: the median
   of a layer's 64 launches timed as one span, or the sum of the 64 plain
   calls' single timed spans, summed over the two layers), then the
   ``{"ok": true, "device": ...}`` line last.

Weights and inputs are random, made from fixed seeds.  The script imports
nothing of JAX and nothing of the reference package ``repro``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (model, compute dtype, batch): the four forwards of the main path
CONFIGS = (
    ("resnet18", "float32", 1),
    ("resnet18", "float32", 8),
    ("resnet18", "bfloat16", 8),
    ("vgg16", "float32", 1),
)
INPUT_SIZE = 224
NUM_CLASSES = 1000
# the SOP + END path: the VGG-16 forward whose image and params it reuses,
# its layers (VGG_FUSION's first two conv levels) and digits
SOP_RUN = "vgg16/float32/b1"
SOP_LEVELS = (0, 1)
SOP_DIGITS = 16
# the paper's Fig. 12 END shares for VGG-16, printed beside this run's
PAPER_VGG_END = "detected 41.08%, undetermined about 2.2%"

# published H100 SXM peaks (dense): HBM bytes/s, float32 outside the
# tensor cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

WARMUP, REPS = 2, 5
# a device-side spin queued before each timed call, long enough (about 5 ms
# at the H100's 1.98 GHz boost clock) that the host's enqueue of the call
# hides behind it and the CUDA events hold device time only
SPIN_CYCLES = 10_000_000


def _tol(ref, dtype: str) -> float:
    """Max-abs-error tolerance of the kernel against a plain PyTorch result.

    float32: both accumulate in float32 but sum up to K*K*Cin = 4608 terms
    per output in different orders, level after level; 1e-4 relative to the
    output's magnitude covers that with margin and is still far below any
    indexing or masking error.  bfloat16: a different float32 sum can round
    to the neighbouring bf16 value (8-bit significand, 2^-8 relative) at
    any level of the pyramid, and such a flip propagates; 2e-2 relative
    allows a few flips and still catches any real error."""
    scale = max(1.0, float(ref.abs().max()))
    return (1e-4 if dtype == "float32" else 2e-2) * scale


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def _median_ms(fn, torch, *, setup=None, spin: bool = True) -> float:
    """Median of per-call CUDA-event times after a warm-up.

    ``setup`` runs before each call, outside the timed span.  With
    ``spin`` the span holds the device's time for the call alone; without
    it, it also holds the time the device waits for the host to enqueue
    the call."""
    for _ in range(WARMUP):
        if setup is not None:
            setup()
        fn()
    times = []
    for _ in range(REPS):
        if setup is not None:
            setup()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class Smoke:
    """State shared by the phases: the card, the plans, the params."""

    def __init__(self, device):
        import torch

        from repro_torch.net.graph import MODELS
        from repro_torch.net.partition import auto_partition
        from repro_torch.net.runner import (
            init_network_params,
            prepare_network_params,
        )

        self.torch = torch
        self.device = device
        self.runs = []
        masters = {}
        for model, dtype, batch in CONFIGS:
            graph = MODELS[model](input_size=INPUT_SIZE,
                                  num_classes=NUM_CLASSES)
            if model not in masters:
                masters[model] = init_network_params(graph, seed=0,
                                                     device=device)
            plan = auto_partition(graph, batch=batch, compute_dtype=dtype)
            gen = torch.Generator(device=device).manual_seed(1 + batch)
            x = torch.randn((batch, INPUT_SIZE, INPUT_SIZE,
                             graph.in_channels), generator=gen, device=device)
            self.runs.append(dict(
                key=f"{model}/{dtype}/b{batch}", graph=graph, plan=plan,
                params=masters[model], dtype=dtype, batch=batch, x=x,
                prepared=prepare_network_params(plan, masters[model]),
            ))
        # per kernel symbol: comparisons and timings of phase 2
        self.stats = {}

    # ---- phase 2 ----------------------------------------------------------

    def pyramid_args(self, run, pyr, *, sparse: bool, seed: int):
        """Padded input, weights, biases and knobs of one pyramid launch."""
        import torch.nn.functional as F

        from repro_torch.core.dtypes import torch_dtype

        torch = self.torch
        prog = pyr.launch.program
        cdt = torch_dtype(prog.compute_dtype)
        graph, prepared = run["graph"], run["prepared"]
        convs = [m for m in pyr.node_names if graph.node(m).op == "conv"]
        spec = pyr.spec
        n, c = spec.input_size, spec.levels[0].n_in
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x = torch.randn((run["batch"], n, n, c), generator=gen,
                        device=self.device)
        biases = [prepared[m][1] for m in convs]
        if sparse:
            # the example's recipe: a blob of signal in one corner, zeros
            # elsewhere, every bias shifted by -0.3; images after the first
            # carry no signal, so at alpha == 1 whole cells die too
            blob = max(4, n // 4)
            x[:, blob:] = 0
            x[:, :, blob:] = 0
            x[:, :blob, :blob] *= 3
            x[1:] = 0
            biases = [(b.float() - 0.3).to(cdt) for b in biases]
        xp = F.pad(x.to(cdt), (0, 0, prog.pad_lo, prog.pad_hi, prog.pad_lo,
                               prog.pad_hi)).contiguous()
        flat = prepared.get("_flat/" + pyr.name)
        weights = None if flat is not None else [prepared[m][0] for m in convs]
        knobs = dict(
            program=prog, relu=pyr.relu, stream_weights=pyr.launch.streamed,
            w_slots=pyr.launch.w_slots, x_slots=pyr.launch.x_slots,
            c_tiles=pyr.launch.c_tiles, weights_flat=flat,
        )
        return xp, weights, biases, knobs

    def compare(self, run, pyr, *, sparse: bool, seed: int, time_it: bool):
        """Kernel vs plain version for one pyramid; returns the skip map."""
        from repro_torch.kernels.fused_conv import fused_conv as fc

        torch = self.torch
        xp, ws, bs, knobs = self.pyramid_args(run, pyr, sparse=sparse,
                                              seed=seed)
        y, skip = fc.fused_pyramid_kernel(xp, ws, bs, **knobs)
        torch.cuda.synchronize()
        plain_kw = {k: knobs[k] for k in ("program", "relu", "weights_flat")}
        y_ref, skip_ref = fc.fused_pyramid_plain(xp, ws, bs, **plain_kw)
        if not torch.equal(skip.cpu(), skip_ref.cpu()):
            raise AssertionError(
                f"{run['key']} {pyr.name}: skip maps differ"
                f" (kernel {int(skip.sum())} vs plain {int(skip_ref.sum())}"
                " skipped levels)"
            )
        err = float((y.float() - y_ref.float()).abs().max())
        tol = _tol(y_ref.float(), run["dtype"])
        if not (err <= tol and bool(torch.isfinite(y.float()).all())):
            raise AssertionError(
                f"{run['key']} {pyr.name} sparse={sparse}: max abs err"
                f" {err} > tol {tol}"
            )
        symbol = (fc.PYRAMID_KTILED if knobs["c_tiles"] > 1
                  else fc.PYRAMID).symbol
        st = self.stats.setdefault(symbol, dict(
            max_abs_err=0.0, ms=0.0, call_ms=0.0, plain_ms=0.0,
            library_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0, rows=[],
        ))
        st["max_abs_err"] = max(st["max_abs_err"], err)
        if time_it:
            ms = self.kernel_ms(run, pyr, xp, ws, bs, knobs, y, skip)
            # the wrapper call as a forward makes it: argument checks,
            # buffer allocation and zeroing, the weight concatenation of a
            # resident pyramid, the ctypes call, and the kernel
            call_ms = _median_ms(
                lambda: fc.fused_pyramid_kernel(xp, ws, bs, **knobs), torch,
                spin=False,
            )
            plain_ms = _median_ms(
                lambda: fc.fused_pyramid_plain(xp, ws, bs, **plain_kw), torch
            )
            library_ms = self.library_ms(run, pyr, xp, ws, bs, knobs)
            bytes_ms, ops_ms = self.bound_ms(pyr, xp, bs, skip, y)
            for k, v in (("ms", ms), ("call_ms", call_ms),
                         ("plain_ms", plain_ms), ("library_ms", library_ms),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms),
                         ("bound_ms", max(bytes_ms, ops_ms))):
                st[k] += v
            st["rows"].append(dict(
                run=run["key"], pyramid=pyr.name, regime=pyr.launch.regime,
                alpha=pyr.launch.program.alpha, q=pyr.q_convs, ms=ms,
                call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                max_abs_err=err,
            ))
        return skip

    def kernel_ms(self, run, pyr, xp, ws, bs, knobs, y, skip) -> float:
        """Device time of the bare kernel launch, with its buffers made
        once beforehand and its live flags and barrier zeroed outside the
        timed span; its result must equal the wrapper's."""
        from repro_torch.core.dtypes import torch_dtype
        from repro_torch.kernels.fused_conv import fused_conv as fc

        torch = self.torch
        prog = knobs["program"]
        kernel, code, desc, bufs = fc.prepare_launch(
            xp, ws, bs, prog, knobs["relu"], True, knobs["c_tiles"],
            knobs["weights_flat"], torch_dtype(prog.compute_dtype),
        )
        live, bar = bufs[7], bufs[8]
        stream = torch.cuda.current_stream().cuda_stream

        def zero():
            live.zero_()
            bar.zero_()

        ms = _median_ms(
            lambda: kernel.launch(code, desc, *bufs, stream=stream), torch,
            setup=zero,
        )
        if not (torch.equal(bufs[3], y) and torch.equal(bufs[4], skip)):
            raise AssertionError(f"{run['key']} {pyr.name}: the bare launch"
                                 " disagrees with the wrapper's")
        return ms

    def library_ms(self, run, pyr, xp, ws, bs, knobs) -> float:
        """One cuDNN chain computing the same pyramid: ``F.conv2d`` (+ReLU)
        and ``F.max_pool2d`` per level on the unpadded NCHW input, in the
        compute dtype, TF32 off.  A yardstick only; the port never calls
        it."""
        import torch.nn.functional as F

        from repro_torch.kernels.fused_conv.fused_conv import _level_weights

        prog = knobs["program"]
        spec = pyr.spec
        lo, n = prog.pad_lo, spec.input_size
        x = xp[:, lo:lo + n, lo:lo + n, :].permute(0, 3, 1, 2).contiguous()
        wl = [w.permute(3, 2, 0, 1).contiguous()
              for w in _level_weights(ws, knobs["weights_flat"], prog)]
        relu = pyr.relu

        def chain():
            t, ci = x, 0
            for lvl in spec.levels:
                if lvl.kind == "conv":
                    t = F.conv2d(t, wl[ci], bs[ci], stride=lvl.S,
                                 padding=lvl.pad)
                    if relu:
                        t = F.relu(t)
                    ci += 1
                else:
                    t = F.max_pool2d(t, lvl.K, lvl.S, padding=lvl.pad)
            return t

        return _median_ms(chain, self.torch)

    def bound_ms(self, pyr, xp, bs, skip, y) -> tuple[float, float]:
        """The least time the card could take for one launch, as (bytes
        time, operations time): every input read once and every output
        written once at the HBM rate, and the multiply-adds (2 FLOPs each)
        of the pyramid's own convolutions at the peak rate of the compute
        dtype.  A conv level counts its global output, ``out^2 * K^2 *
        Cin * Cout`` per image as a layer-by-layer chain computes it, so no
        halo recompute and no tile overhang, scaled by the share of grid
        cells the END cascade left live at that level in this run.  The
        pools' comparisons are not counted."""
        prog = pyr.launch.program
        bpv = prog.bytes_per_val
        nbytes = (
            xp.numel() * bpv
            + sum(prog.level_weight_counts()) * bpv
            + sum(b.numel() for b in bs) * bpv
            + y.numel() * bpv
            + skip.numel() * 4
        )
        batch = xp.shape[0]
        cells = skip.shape[0] * skip.shape[1] * skip.shape[2]
        live = (skip == 0).sum(dim=(0, 1, 2)).cpu().tolist()  # per conv level
        spec = pyr.spec
        convs = [(lvl, n) for lvl, n in zip(spec.levels, spec.feature_sizes())
                 if lvl.kind == "conv"]
        flops = sum(
            2 * batch * lvl.out_size(n) ** 2 * lvl.K ** 2 * lvl.n_in
            * lvl.n_out * cells_live / cells
            for (lvl, n), cells_live in zip(convs, live)
        )
        return (nbytes / HBM_BYTES_PER_S * 1e3,
                flops / PEAK_FLOPS[prog.compute_dtype] * 1e3)

    def phase_pyramids(self) -> None:
        mixed = False
        for ri, run in enumerate(self.runs):
            for pi, pyr in enumerate(run["plan"].pyramids):
                seed = 100 * ri + pi
                self.compare(run, pyr, sparse=False, seed=seed, time_it=True)
                if pyr.q_convs > 1 and pyr.relu:
                    skip = self.compare(run, pyr, sparse=True, seed=seed,
                                        time_it=False)
                    deep = skip[..., 1:]
                    mixed |= 0 < int(deep.sum()) < deep.numel()
            print(f"pyramids {run['key']}: {run['plan'].n_launches()} launches"
                  " match their plain version", flush=True)
        if not mixed:
            raise AssertionError("no sparse case mixed live and dead tiles")

    # ---- phase 3 ----------------------------------------------------------

    def phase_end_to_end(self) -> dict[str, int]:
        """Every forward of the main path once, each counted on its own
        against its plan; then checked.  Returns each kernel's launches
        summed over the forwards."""
        from repro_torch.kernels import build
        from repro_torch.kernels.fused_conv import fused_conv as fc
        from repro_torch.net.runner import run_network

        totals = {k.symbol: 0 for k in fc.KERNELS}
        for run in self.runs:
            build.reset_launch_counts()
            run["logits"], run["skips"] = run_network(
                run["x"], run["prepared"], plan=run["plan"]
            )
            counts = {k.symbol: k.launches for k in build.KERNELS}
            expect = {k.symbol: 0 for k in build.KERNELS}
            for pyr in run["plan"].pyramids:
                expect[(fc.PYRAMID_KTILED if pyr.launch.c_tiles > 1
                        else fc.PYRAMID).symbol] += 1
            if counts != expect:
                raise AssertionError(f"{run['key']}: launch counts {counts}"
                                     f" != its plan's {expect}")
            run["launches"] = counts
            for sym in totals:
                totals[sym] += counts[sym]
        self.torch.cuda.synchronize()
        if any(v == 0 for v in totals.values()):
            raise AssertionError(f"a kernel of the path never ran: {totals}")
        for run in self.runs:
            self.check_logits(run)
        return totals

    def check_logits(self, run) -> None:
        from repro_torch.net.graph import infer_shapes
        from repro_torch.net.runner import bf16_logit_tol, reference_network

        torch = self.torch
        graph = run["graph"]
        logits = run["logits"].float()
        want = (run["batch"], infer_shapes(graph)[graph.output.name].channels)
        if tuple(logits.shape) != want or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{run['key']}: logits {tuple(logits.shape)}"
                                 " not finite or not of the expected shape")
        ref = reference_network(run["x"], run["graph"], run["params"])
        err = float((logits - ref).abs().max())
        tol = (_tol(ref, "float32") if run["dtype"] == "float32"
               else bf16_logit_tol(ref))
        if not err <= tol:
            raise AssertionError(f"{run['key']}: logits max abs err {err}"
                                 f" > tol {tol}")
        t = _forward_ms(run, torch)
        rows = [r for st in self.stats.values() for r in st["rows"]
                if r["run"] == run["key"]]
        run["summary"] = dict(
            run=run["key"], launches=run["launches"],
            logits_max_abs_err=err, tol=tol, forward_ms=t,
            **{f"sum_{k}": sum(r[k] for r in rows) for k in (
                "ms", "call_ms", "bound_ms", "plain_ms", "library_ms")},
        )
        print("end to end " + json.dumps(run["summary"]), flush=True)

    # ---- phase 4 ----------------------------------------------------------

    def sop_layers(self) -> list[dict]:
        """Per layer of the SOP path: its scaled windows ``x`` (P, m), the
        power of two ``e`` they were scaled by, the filters ``ys`` (Cout,
        m) in the windows' ``(Cin, K, K)`` order, and the layer's pre-bias
        convolution ``ref`` (P, Cout) on the card."""
        import math

        from repro_torch.core.cnn_models import VGG_FUSION
        from repro_torch.core.executor import (
            conv2d_nhwc,
            conv_windows,
            full_fp32,
        )

        torch = self.torch
        run = next(r for r in self.runs if r["key"] == SOP_RUN)
        spec = VGG_FUSION
        if spec.input_size != INPUT_SIZE:
            raise AssertionError(f"VGG_FUSION is at {spec.input_size}²")
        layers, a = [], run["x"]
        with full_fp32():
            for level in SOP_LEVELS:
                lvl = spec.levels[level]
                w, b = run["params"][lvl.name]
                win = conv_windows(a, spec, level)[0][0]
                e = math.floor(math.log2(float(win.abs().max()))) + 1
                layers.append(dict(
                    name=lvl.name, e=e,
                    x=(win * 2.0 ** -e).contiguous(),
                    # HWIO -> (Cout, Cin, K, K): the windows' feature order
                    ys=w.permute(3, 2, 0, 1).reshape(lvl.n_out, -1)
                    .contiguous(),
                    ref=conv2d_nhwc(a, w, None, lvl.S, lvl.pad)
                    .reshape(-1, lvl.n_out),
                ))
                a = torch.relu(conv2d_nhwc(a, w, b, lvl.S, lvl.pad))
        return layers

    def phase_sop(self) -> dict:
        """The SOP + END path once (one call per filter of each layer),
        counted; then checked against the convolution and the plain
        version, and timed.  Returns the kernel's entry of the kernels
        line."""
        from repro_torch.kernels import build
        from repro_torch.kernels.online_sop import online_sop as tos
        from repro_torch.kernels.online_sop import online_sop_end

        torch = self.torch
        layers = self.sop_layers()
        torch.cuda.synchronize()
        build.reset_launch_counts()
        for lay in layers:
            lay["out"] = [online_sop_end(lay["x"], y, SOP_DIGITS)
                          for y in lay["ys"]]
        counts = {k.symbol: k.launches for k in build.KERNELS}
        torch.cuda.synchronize()
        n_filters = sum(len(lay["ys"]) for lay in layers)
        expect = {k.symbol: 0 for k in build.KERNELS}
        expect[tos.SOP_END.symbol] = n_filters
        if counts != expect:
            raise AssertionError(f"sop: launch counts {counts} != {expect}")
        st = dict(max_abs_err=0.0, near_ties=0, ms=0.0, call_ms=0.0,
                  plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                  layers=[])
        for lay in layers:
            row = self.check_sop_layer(lay, tos)
            row.update(self.time_sop_layer(lay, tos))
            for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bytes_ms",
                      "ops_ms"):
                st[k] += row[k]
            st["max_abs_err"] = max(st["max_abs_err"], row["max_abs_err"])
            st["near_ties"] += row["near_ties"]
            st["layers"].append(row)
            print("sop " + json.dumps(row), flush=True)
        self.sop_rows = st["layers"]
        return dict(
            name=tos.SOP_END.symbol, route="cuda", source=tos.SOP_END.source,
            replaces=tos.SOP_END.replaces,
            launches=counts[tos.SOP_END.symbol],
            launches_per_layer={r["layer"]: r["launches"]
                                for r in st["layers"]},
            max_abs_err=st["max_abs_err"], ms=st["ms"], call_ms=st["call_ms"],
            plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
            bound_by="bytes" if st["bytes_ms"] >= st["ops_ms"]
            else "operations",
            # no single PyTorch call computes termination cycles
            library_ms=None, near_ties=st["near_ties"],
        )

    def check_sop_layer(self, lay, tos) -> dict:
        """The layer's checks, raising on failure; returns its END shares,
        its kernel-vs-plain figures and ``plain_ms``, the sum of its plain
        calls' device times (each one span behind a spin, after one
        untimed warm-up call)."""
        torch = self.torch
        name, x = lay["name"], lay["x"]
        sop = torch.stack([o[0] for o in lay["out"]], dim=1)  # (P, Cout)
        cyc = torch.stack([o[1] for o in lay["out"]], dim=1)
        det = torch.stack([o[2] for o in lay["out"]], dim=1)
        ref = lay["ref"]
        err = float((sop * 2.0 ** lay["e"] - ref).abs().max())
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        if not err <= tol:
            raise AssertionError(f"sop {name}: sop * 2^{lay['e']} is {err}"
                                 f" from the convolution (tol {tol})")
        if bool((det & (sop >= 0)).any()):
            raise AssertionError(f"sop {name}: a detected row has sop >= 0")
        max_err, ties, plain_ms = 0.0, 0, 0.0
        tos.online_sop_end_plain(x, lay["ys"][0], SOP_DIGITS)
        for f, (y, got) in enumerate(zip(lay["ys"], lay["out"])):
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            plain = tos.online_sop_end_plain(x, y, SOP_DIGITS)
            b.record()
            b.synchronize()
            plain_ms += a.elapsed_time(b)
            e = float((got[0] - plain[0]).abs().max())
            if not e <= 1e-5 * max(1.0, float(got[0].abs().max())):
                raise AssertionError(f"sop {name} filter {f}: sop differs"
                                     f" from the plain version by {e}")
            max_err = max(max_err, e)
            rows, margins, tie = tos.latch_disagreements(x, y, SOP_DIGITS,
                                                         got, plain)
            for r, mg in zip(rows.tolist(), margins.tolist()):
                print(f"sop {name} filter {f} row {r}: cycle/flag"
                      f" {int(got[1][r])}/{bool(got[2][r])} vs plain"
                      f" {int(plain[1][r])}/{bool(plain[2][r])}, margin {mg}"
                      f" (near-tie band {tie})", flush=True)
                if not mg <= tie:
                    raise AssertionError(f"sop {name} filter {f} row {r}:"
                                         " END differs beyond a near-tie")
            ties += len(rows)
        neg = sop < 0
        return dict(
            layer=name, launches=len(lay["out"]), P=x.shape[0], m=x.shape[1],
            scale_exp=lay["e"], conv_max_abs_err=err, conv_tol=tol,
            max_abs_err=max_err, near_ties=ties, plain_ms=plain_ms,
            negative_share=float(neg.float().mean()),
            detected_share=float(det.float().mean()),
            undetermined_share=float((neg & ~det).float().mean()),
            mean_detect_cycle=float(cyc[det].float().mean())
            if bool(det.any()) else float(SOP_DIGITS),
            paper_fig12_vgg=PAPER_VGG_END,
        )

    def time_sop_layer(self, lay, tos) -> dict:
        """The layer's 64 launches, timed as one span (median of the
        spans): the bare kernel into buffers made beforehand, behind a
        spin, and the wrapper call as the path makes it (no spin); and the
        bound of the 64."""
        from repro_torch.kernels.online_sop import online_sop_end

        torch = self.torch
        x, ys = lay["x"], lay["ys"]
        P, m = x.shape
        sop = torch.empty(P, dtype=torch.float32, device=self.device)
        cyc = torch.empty(P, dtype=torch.int32, device=self.device)
        det = torch.empty(P, dtype=torch.bool, device=self.device)
        stream = torch.cuda.current_stream().cuda_stream

        def bare():
            for y in ys:
                tos.launch(x, y, sop, cyc, det, SOP_DIGITS, stream=stream)

        ms = _median_ms(bare, torch)
        got = lay["out"][-1]
        if not (torch.equal(sop, got[0]) and torch.equal(cyc, got[1])
                and torch.equal(det, got[2])):
            raise AssertionError(f"sop {lay['name']}: the bare launch"
                                 " disagrees with the wrapper's")
        call_ms = _median_ms(
            lambda: [online_sop_end(x, y, SOP_DIGITS) for y in ys], torch,
            spin=False)
        # per launch, each input read once, each output written once; a
        # d*y multiply-add per element and digit plus the x*y one
        nbytes = len(ys) * ((x.numel() + m) * 4 + P * (4 + 4 + 1))
        ops = len(ys) * 2 * P * m * (SOP_DIGITS + 1)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_FLOPS["float32"] * 1e3
        return dict(ms=ms, call_ms=call_ms,
                    bytes_ms=bytes_ms, ops_ms=ops_ms,
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _forward_ms(run, torch) -> float:
    """Median host time of a whole forward, ended by a synchronize."""
    from repro_torch.net.runner import run_network

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_network(run["x"], run["prepared"], plan=run["plan"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the per-pyramid timings as JSON here")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels.fused_conv import fused_conv as fc

        t0 = time.perf_counter()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        reports = build.build()
        nvcc = subprocess.run([build.find_nvcc(), "--version"],
                              capture_output=True, text=True, check=True)
        try:
            import triton

            triton_version = triton.__version__
        except ImportError:
            triton_version = "absent"
        print(_smi(), flush=True)
        print(f"python {sys.version.split()[0]} torch {torch.__version__}"
              f" cuda {torch.version.cuda} triton {triton_version}"
              f" nvcc {nvcc.stdout.strip().splitlines()[-1]}"
              f" built {sorted(reports)} in {time.perf_counter() - t0:.1f}s",
              flush=True)
        device = torch.device("cuda")
        smoke = Smoke(device)
        smoke.phase_pyramids()
        counts = smoke.phase_end_to_end()
        sop = smoke.phase_sop()
        kernels = []
        for k in fc.KERNELS:
            st = smoke.stats[k.symbol]
            kernels.append(dict(
                name=k.symbol, route="cuda", source=k.source,
                replaces=k.replaces, launches=counts[k.symbol],
                launches_per_forward={r["key"]: r["launches"][k.symbol]
                                      for r in smoke.runs},
                max_abs_err=st["max_abs_err"], ms=st["ms"],
                call_ms=st["call_ms"],
                plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
                bound_by=("bytes" if st["bytes_ms"] >= st["ops_ms"]
                          else "operations"),
                library_ms=st["library_ms"],
            ))
        kernels.append(sop)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(dict(
                card=_smi(), kernels=kernels,
                pyramids={s: v["rows"] for s, v in smoke.stats.items()},
                end_to_end=[r["summary"] for r in smoke.runs],
                sop=smoke.sop_rows,
                seconds=time.perf_counter() - t0,
            ), indent=1))
        print(json.dumps({"kernels": kernels}), flush=True)
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
