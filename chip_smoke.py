#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Run from the root of a checkout on a machine with one H100 and nvcc:

    python3 chip_smoke.py [--out FILE.json]

The main path is the paper's contribution, a CNN forward through fused conv
pyramids: the zoo graph (``repro_torch.net.graph``), the auto-partitioner's
cuts (``repro_torch.net.partition.auto_partition``) and the plan-driven
``repro_torch.net.runner.run_network``, one hand-written CUDA pyramid kernel
launch per pyramid; phase 6 runs it again traced and guarded.  The second path is the paper's other half, the
digit-serial sum of products with Early Negative Detection
(``repro_torch.kernels.online_sop.online_sop_end``) on VGG-16's first two
conv layers.  The third is the Mamba-2 language model's prefill and decode,
whose prefill runs the SSD chunk scan
(``repro_torch.kernels.ssd_scan.ops.ssd_scan``) once per layer.  Phases,
any failure exits non-zero:

1. build  — compile every kernel of the three paths from ``src/repro_torch/csrc``
   (one nvcc per source, started together); print the card's name and
   power limit, torch, CUDA and nvcc versions, the pyramid kernels', the
   SOP kernel's and the SSD scan's ``ptxas`` lines (registers, stack,
   spills), the pyramid
   kernels' co-resident block count per dtype and the SSD scan's blocks a
   SM per instance at the Mamba-2 model's (P, N, Q).
2. pyramids — for every pyramid of the four plans below, the kernel against
   its plain PyTorch version on the card, on dense inputs and on sparse
   ones with negative-shifted biases (the END cascade): skip maps must be
   equal and outputs within the tolerance stated at ``_tol``.  Each dense
   pyramid is also timed (the bare kernel, the wrapper call, the plain
   version, a cuDNN chain) and bounded; its row names each level's conv
   tile and the TFLOP/s its bare time makes of the bound's FLOPs.
3. end to end — ``run_network`` at full width (224x224 input, 1000
   classes) for ResNet-18 f32 batch 1 and 8, ResNet-18 bf16 batch 8 and
   VGG-16 f32 batch 1, each held against the port's ``reference_network``
   on the card (f32 within ``_tol``, bf16 within ``bf16_logit_tol``), with
   every kernel's launch count reset just before each forward and checked
   just after against that forward's plan.
4. sop — the windows of VGG-16 ``CONV1`` (of the VGG image above) and
   ``CONV2`` (of ``relu(CONV1)``) at 224², P = 50,176 each, scaled by one
   power of two into (-1, 1), through ``online_sop_end`` once per layer
   with all 64 filters as ``y (64, m)`` (16 digits), with the launch counts
   reset just before and checked just after (2, one a layer, all through
   the kernel).  Checked, for every filter's column: ``sop`` times the
   scale equals the layer's pre-bias convolution; the kernel equals its
   plain version (``sop`` within 1e-5 relative, cycles and flags equal
   except at printed near-ties, see ``latch_disagreements``); no flagged
   row has ``sop >= 0``.  Each layer's launch is timed (bare and through
   the wrapper) and bounded (x read once a layer; the digit products at
   the int8 rate, ``x * y`` at the float32 rate; ``ops_ms_f32``, every
   operation at the float32 rate, beside it), every filter's plain version
   as it is checked, and one single-filter launch at ``CONV2``; per-layer
   END shares are printed beside the paper's Fig. 12.
5. lm — Mamba-2-780m (``repro_torch.configs.mamba2_780m``) at full width
   and depth, random weights from a seed, through the port's entry points
   (``launch.steps.make_prefill_step`` / ``make_decode_step``,
   ``launch.serve.serve``): the bf16 prefill of 4 x 4096 tokens (chunk
   256) with the launch counts reset just before and checked just after
   (48 launches of the SSD chunk-scan kernel, one per layer), each layer's
   kernel ``y`` and state held against ``ssd_scan_plain`` on that layer's
   captured inputs (``plain_tol``), layer 0 again at f32, the logits
   finite and printed against a forward with the plain version in the
   kernel's place; layer 0's x, B, C with a slowly decaying state (the
   carried state weighs in each chunk) against the plain version and
   against a run one chunk shorter advanced by hand; the kernel timed (the
   48 bare launches, the 48 wrapper calls, the plain versions, and the
   float32 instance's bare launch on layer 0's widened inputs) and bounded
   at the peak rate of x's type (``ops_ms_f32`` beside it); the bf16
   prefill of the prefill_32k cell (32 x 32,768 tokens) with its launch
   counts checked, timed; the f32 prefill of 2 x 512
   through the kernel against 512 decode steps over the same prompt
   (``ssd_decode_step``, no kernel) within ``_recurrence_tol``; ``serve``
   at bf16 answering 4 requests.
6. ops — phase 3's ResNet-18 f32 and VGG-16 f32 batch-1 forwards observed
   and guarded (``repro_torch.obs``, ``repro_torch.robust``): each traced
   three times (per forward a span per launch with a positive CUDA-event
   time on this card, logits and skip maps as the untraced forward's, the
   run_network and end_skip_counts events), all in one Chrome trace that
   must validate
   (written next to ``--out``, else to a temporary directory) with the
   drift report printed; each guarded with no fault (no fallback, every
   launch clean, the kernels' launch counts reset just before and equal to
   the plan's just after, logits against ``reference_network``); then four
   faults on ResNet-18, each with a fresh injector — a launch failure on
   the first pyramid (one ``eager`` event), a poisoned output of the
   channel-tiled launch (one ``reference`` event), a budget squeeze (the
   mildest that splits a launch: ``replan`` into >= 2 sub-launches) and a
   corrupted conv weight with a clean source (one ``heal`` event) — each
   with its launch counts checked against the rungs, logits against
   ``reference_network`` and the untouched launches' skip maps against the
   clean run's; forward latency (``timed_stats_ms``: median of 3 after a
   warm-up) traced and guarded beside phase 3's untraced forward, every
   timed guarded forward checked clean and every timed forward's launches
   counted, with the preflight alone and the sentinel reads of one
   forward's launch outputs alone; and
   ``python -m repro_torch.obs.explain --model resnet18 --run --guard
   --trace FILE`` as a subprocess.  Its launches go on an ``ops launches``
   line of their own.
7. results — one ``{"kernels": [...]}`` line (for the pyramid kernels
   ``launches`` sums the four forwards, ``launches_per_forward`` splits
   it, and every time sums the per-launch medians over the dense pyramids
   of the four plans; for the SOP kernel ``launches_per_layer`` splits
   the 2 and every time sums the two layers: the median of a layer's
   launch, or the sum of its 64 plain calls' single timed spans; for the
   SSD kernel ``launches`` is the bf16 prefill's 48 and every time covers
   its 48 layers), then the ``{"ok": true, "device": ...}`` line last.

Weights and inputs are random, made from fixed seeds.  The script imports
nothing of JAX and nothing of the reference package ``repro``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
# the single-filter kernel's time a launch at CONV2 before the filter axis
# (chip_smoke.py on an H100 80GB HBM3 at 700 W: 15.838 ms / 64 launches)
SOP_F1_BEFORE_MS = 15.838 / 64

# published H100 SXM peaks (dense): HBM bytes/s, float32 outside the
# tensor cores, bf16 and int8 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}

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
            # the bound's FLOPs over the bare kernel's time
            flops = ops_ms * 1e-3 * PEAK_FLOPS[run["dtype"]]
            for k, v in (("ms", ms), ("call_ms", call_ms),
                         ("plain_ms", plain_ms), ("library_ms", library_ms),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms),
                         ("bound_ms", max(bytes_ms, ops_ms))):
                st[k] += v
            st["rows"].append(dict(
                run=run["key"], pyramid=pyr.name, regime=pyr.launch.regime,
                alpha=pyr.launch.program.alpha, q=pyr.q_convs,
                tiles=fc.level_tiles(pyr.launch.program),
                tflops=flops / (ms * 1e-3) / 1e12, ms=ms,
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
        t = _forward_ms(run)
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
        """The SOP + END path once (one call per layer, all its filters),
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
            lay["out"] = online_sop_end(lay["x"], lay["ys"], SOP_DIGITS)
        counts = {k.symbol: k.launches for k in build.KERNELS}
        torch.cuda.synchronize()
        expect = {k.symbol: 0 for k in build.KERNELS}
        expect[tos.SOP_END.symbol] = len(layers)
        if counts != expect:
            raise AssertionError(f"sop: launch counts {counts} != {expect}")
        st = dict(max_abs_err=0.0, near_ties=0, ms=0.0, call_ms=0.0,
                  plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                  ops_ms_f32=0.0, layers=[])
        for lay in layers:
            row = self.check_sop_layer(lay, tos)
            row.update(self.time_sop_layer(lay, tos))
            for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bytes_ms",
                      "ops_ms", "ops_ms_f32"):
                st[k] += row[k]
            st["max_abs_err"] = max(st["max_abs_err"], row["max_abs_err"])
            st["near_ties"] += row["near_ties"]
            st["layers"].append(row)
            print("sop " + json.dumps(row), flush=True)
        self.sop_rows = st["layers"]
        f1 = next(r["f1_ms"] for r in st["layers"] if "f1_ms" in r)
        print(f"sop CONV2 one filter, one launch: {f1:.4f} ms (the"
              f" single-filter kernel before the filter axis:"
              f" {SOP_F1_BEFORE_MS:.4f} ms)", flush=True)
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
            bytes_ms=st["bytes_ms"], ops_ms=st["ops_ms"],
            ops_ms_f32=st["ops_ms_f32"], conv2_one_filter_ms=f1,
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
        sop, cyc, det = lay["out"]  # (P, Cout) each
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
        for f, y in enumerate(lay["ys"]):
            got = (sop[:, f], cyc[:, f], det[:, f])
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
            layer=name, launches=1, filters=len(lay["ys"]), P=x.shape[0],
            m=x.shape[1],
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
        """The layer's one launch: the bare kernel into buffers made
        beforehand, behind a spin, and the wrapper call as the path makes
        it (no spin), medians of their spans; at ``CONV2`` also one
        single-filter launch; and the bound."""
        from repro_torch.kernels.online_sop import online_sop_end

        torch = self.torch
        x, ys = lay["x"], lay["ys"]
        (P, m), F = x.shape, len(ys)
        stream = torch.cuda.current_stream().cuda_stream

        def buffers(n):
            return [torch.empty((P, n), dtype=dt, device=self.device)
                    for dt in (torch.float32, torch.int32, torch.bool)]

        w, out = tos.prepare_weights(ys), buffers(F)
        ms = _median_ms(lambda: tos.launch(x, w, *out, SOP_DIGITS,
                                           stream=stream), torch)
        if not all(torch.equal(a, b) for a, b in zip(out, lay["out"])):
            raise AssertionError(f"sop {lay['name']}: the bare launch"
                                 " disagrees with the wrapper's")
        call_ms = _median_ms(lambda: online_sop_end(x, ys, SOP_DIGITS),
                             torch, spin=False)
        timed = {}
        if lay["name"] == "CONV2":
            w1, out1 = tos.prepare_weights(ys[:1].contiguous()), buffers(1)
            timed["f1_ms"] = _median_ms(
                lambda: tos.launch(x, w1, *out1, SOP_DIGITS, stream=stream),
                torch)
        # the least work: x read once, Y once, the three (P, F) outputs
        # written once; a digit product per element, digit and filter at
        # the int8 rate, and the x * y multiply-add at the float32 rate
        nbytes = (x.numel() + F * m) * 4 + P * F * (4 + 4 + 1)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = (2 * P * m * F * SOP_DIGITS / PEAK_FLOPS["int8"]
                  + 2 * P * m * F / PEAK_FLOPS["float32"]) * 1e3
        # every operation at the float32 rate, as the bound counted them
        # when each filter was its own launch
        ops_ms_f32 = (2 * P * m * F * (SOP_DIGITS + 1)
                      / PEAK_FLOPS["float32"] * 1e3)
        bound_ms = max(bytes_ms, ops_ms)
        return dict(ms=ms, call_ms=call_ms, **timed,
                    bytes_ms=bytes_ms, ops_ms=ops_ms, ops_ms_f32=ops_ms_f32,
                    bound_ms=bound_ms,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    times_bound=ms / bound_ms)


# ---- phase lm -------------------------------------------------------------

# Mamba-2-780m at full width and full depth (48 layers, d_model 1536, 48
# heads of 64, state 128, vocab 50280, chunk 256), random weights from a
# seed.  The timed prefill runs the reference's prefill_32k cell itself (32
# sequences of 32,768 tokens; 58.4 GB at its peak on an H100 80GB HBM3, 27
# s a forward).  The checked prefill, which captures every layer's SSD
# inputs and outputs to hold each against the plain version, is cut to
# 4 x 4096 (16 chunks, the state carried 15 times per sequence and layer):
# the capture keeps some 217 MB a layer for those 16,384 tokens, 10.4 GB
# for the 48 layers, and would need 64 times that at the full cell, far
# more than the card's 80 GB.
LM_ARCH = "mamba2_780m"
LM_PREFILL = (4, 4096)  # bf16: kernel against plain on every layer
LM_TIMED = (32, 32768)  # bf16: the prefill_32k cell, timed and counted
LM_RECURRENCE = (2, 512)  # f32: prefill through D against 512 decode steps
LM_SERVE = dict(batch=4, prompt_len=16, new_tokens=32)


def _recurrence_tol(ref) -> float:
    """Bound on the f32 prefill-through-kernel logits against the decode
    recurrence's.  The two paths share no SSD code: the chunked scan sums
    each output over a chunk's keys and a carried state, the recurrence
    updates the state token by token, and both feed the result through 48
    layers and a residual stream in float32, so they differ by rounding
    that 48 layers compound.  1e-3 of the logits' magnitude holds that with
    margin and is far below what a wrong decay, mask or carried state gives
    (errors of the logits' own size)."""
    return 1e-3 * max(1.0, float(ref.abs().max()))


class Lm:
    """Phase lm: the Mamba-2-780m prefill and decode path of the port."""

    def __init__(self, torch, device):
        from repro_torch.configs import get_config

        self.torch = torch
        self.device = device
        self.cfg = get_config(LM_ARCH)
        self.summary = {}

    def _tokens(self, shape, seed):
        gen = self.torch.Generator(device=self.device).manual_seed(seed)
        return self.torch.randint(0, self.cfg.vocab, shape, generator=gen,
                                  device=self.device)

    def _counts(self):
        from repro_torch.kernels import build

        return {k.symbol: k.launches for k in build.KERNELS}

    def _expect(self, n):
        from repro_torch.kernels import build
        from repro_torch.kernels.ssd_scan import ssd_scan as kd

        want = {k.symbol: 0 for k in build.KERNELS}
        want[kd.SSD_SCAN.symbol] = n
        return want

    def prefill_bf16(self) -> dict:
        """Check 1: the bf16 prefill with every layer's SSD inputs and
        outputs captured, counted; each layer's kernel result held against
        ``ssd_scan_plain``; one layer again at f32; the logits against a
        forward with the plain version in the kernel's place; timings."""
        from repro_torch.kernels import build
        from repro_torch.kernels.ssd_scan import ops
        from repro_torch.kernels.ssd_scan import ssd_scan as kd
        from repro_torch.launch.steps import make_prefill_step
        from repro_torch.models import ssm
        from repro_torch.models.model import init_params

        torch, cfg = self.torch, self.cfg
        params = self.params = init_params(cfg, 0, device=self.device)
        tokens = self._tokens(LM_PREFILL, 3)
        prefill = make_prefill_step(cfg)
        layers = []
        real = ssm.ssd_scan

        def recording(x, dt, A, B, C, D, *, chunk):
            y, state = real(x, dt, A, B, C, D, chunk=chunk)
            layers.append(dict(args=kd.prepare(x, dt, A, B, C, D, chunk),
                               chunk=chunk, y=y, state=state))
            return y, state

        torch.cuda.synchronize()
        ssm.ssd_scan = recording
        try:
            build.reset_launch_counts()
            logits = prefill(params, {"tokens": tokens})
            counts = self._counts()
        finally:
            ssm.ssd_scan = real
        torch.cuda.synchronize()
        if counts != self._expect(cfg.n_layers) or len(layers) != cfg.n_layers:
            raise AssertionError(f"lm prefill: launch counts {counts}, {len(layers)}"
                                 f" layers captured; want {cfg.n_layers}")
        lg = logits.float()
        if (tuple(lg.shape) != (LM_PREFILL[0], cfg.vocab)
                or not bool(torch.isfinite(lg).all())):
            raise AssertionError(f"lm prefill: logits {tuple(lg.shape)} not"
                                 " finite or not of the expected shape")
        # every layer: the kernel's y and state against the plain version
        err_y = err_s = mag_y = mag_s = plain_ms = 0.0
        for i, lay in enumerate(layers):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            py, ps = kd.ssd_scan_plain(*lay["args"], chunk=lay["chunk"])
            b.record()
            b.synchronize()
            plain_ms += a.elapsed_time(b)
            ey = float((lay["y"].float() - py.float()).abs().max())
            es = float((lay["state"] - ps).abs().max())
            ty = kd.plain_tol(py.float(), py.dtype)
            ts = kd.plain_tol(ps, torch.float32)
            if not (ey <= ty and es <= ts):
                raise AssertionError(f"lm layer {i}: kernel vs plain y err {ey}"
                                     f" (tol {ty}), state err {es} (tol {ts})")
            err_y, err_s = max(err_y, ey), max(err_s, es)
            mag_y = max(mag_y, float(py.float().abs().max()))
            mag_s = max(mag_s, float(ps.abs().max()))
        # one layer at f32: the same inputs, widened
        args32 = [t.float() for t in layers[0]["args"]]
        ky, ks = kd.ssd_scan_kernel(*args32, chunk=layers[0]["chunk"])
        py, ps = kd.ssd_scan_plain(*args32, chunk=layers[0]["chunk"])
        err32 = float((ky - py).abs().max())
        serr32 = float((ks - ps).abs().max())
        tol32 = kd.plain_tol(py, torch.float32)
        stol32 = kd.plain_tol(ps, torch.float32)
        if not (err32 <= tol32 and serr32 <= stol32):
            raise AssertionError(f"lm layer 0 at f32: y err {err32} (tol"
                                 f" {tol32}), state err {serr32} (tol {stol32})")
        stream = torch.cuda.current_stream().cuda_stream
        f32_ms = _median_ms(
            lambda: kd.launch(*args32, ky, ks, layers[0]["chunk"],
                              stream=stream), torch)
        del args32, ky, ks, py, ps
        slow = self.slow_decay(layers[0], kd)
        timing = self.time_kernel(layers, kd)
        bound = self.bound(layers)
        for lay in layers:
            del lay["args"], lay["y"], lay["state"]
        # the same forward with the plain version in the kernel's place
        saved = ops.ssd_scan_kernel
        ops.ssd_scan_kernel = kd.ssd_scan_plain
        try:
            plain_logits = prefill(params, {"tokens": tokens}).float()
        finally:
            ops.ssd_scan_kernel = saved
        fwd_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(fwd_ms)
        row = dict(
            cell=f"prefill bf16 {LM_PREFILL[0]}x{LM_PREFILL[1]}",
            launches=counts[kd.SSD_SCAN.symbol],
            y_max_abs_err=err_y, state_max_abs_err=err_s,
            max_abs_y=mag_y, max_abs_state=mag_s,
            f32_layer0_y_max_abs_err=err32, f32_layer0_state_max_abs_err=serr32,
            f32_layer0_ms=f32_ms,
            **slow,
            logits_vs_plain_forward=float((lg - plain_logits).abs().max()),
            max_abs_logit=float(lg.abs().max()),
            forward_ms=ms, tokens_per_s=LM_PREFILL[0] * LM_PREFILL[1] / ms * 1e3,
            plain_ms=plain_ms, **timing, **bound,
        )
        print("lm " + json.dumps(row), flush=True)
        self.summary["prefill_bf16"] = row
        return row

    def slow_decay(self, lay, kd) -> dict:
        """Layer 0's x, B, C and D with a slowly decaying state: dt
        log-uniform in [1e-3, 0.1] (Mamba-2's dt initialisation range) and
        A = -10^u for u evenly from -2 to 0 across the heads, so that
        exp(sum dt A) over a chunk of 256 runs from about 0.95 down to
        about 0.005 and the state carried into a chunk weighs in its
        result (with the model's random init it decays to nothing within a
        chunk).  The kernel's y and state against the plain version, and
        its state against a run one chunk shorter advanced over the last
        chunk by hand: exp(sum_last dt A) h_short plus the plain version's
        state of the last chunk alone."""
        torch = self.torch
        x, _, _, B, C, D = lay["args"]
        Q = lay["chunk"]
        b, S, H, _ = x.shape
        gen = torch.Generator(device=self.device).manual_seed(5)
        u = torch.rand((b, S, H), generator=gen, device=self.device)
        dt = torch.exp(math.log(1e-3) + u * math.log(100.0))
        A = -torch.logspace(-2, 0, H, device=self.device)
        args = (x, dt, A, B, C, D)
        per_chunk = torch.exp((dt * A).reshape(b, S // Q, Q, H).sum(2))
        median = float(per_chunk.median())
        if not median > 0.05:
            raise AssertionError(f"lm slow decay: median chunk decay {median}")
        y, state = kd.ssd_scan_kernel(*args, chunk=Q)
        py, ps = kd.ssd_scan_plain(*args, chunk=Q)
        _, h_short = kd.ssd_scan_kernel(*(t[:, :S - Q] if t.dim() > 1 else t
                                          for t in args), chunk=Q)
        _, h_last = kd.ssd_scan_plain(*(t[:, S - Q:] if t.dim() > 1 else t
                                        for t in args), chunk=Q)
        want = h_short * per_chunk[:, -1, :, None, None] + h_last
        ey = float((y.float() - py.float()).abs().max())
        es = float((state - ps).abs().max())
        ec = float((state - want).abs().max())
        ty = kd.plain_tol(py.float(), py.dtype)
        ts = kd.plain_tol(ps, torch.float32)
        tc = kd.plain_tol(want, torch.float32)
        if not (ey <= ty and es <= ts and ec <= tc):
            raise AssertionError(
                f"lm slow decay: y err {ey} (tol {ty}), state err {es} (tol"
                f" {ts}), against the advanced shorter run {ec} (tol {tc})")
        return dict(slow_decay_median_chunk_decay=median,
                    slow_decay_max_abs_y=float(py.float().abs().max()),
                    slow_decay_max_abs_state=float(ps.abs().max()),
                    slow_decay_y_max_abs_err=ey,
                    slow_decay_state_max_abs_err=es,
                    slow_decay_carry_max_abs_err=ec)

    def prefill_full(self) -> dict:
        """The prefill_32k cell at bf16, no capture: the launch counts of
        one forward, and the median host time of three after a warm-up,
        with each SSD call's device time taken by CUDA events around it
        (the wrapper's casts and launch; no pad at this length)."""
        from repro_torch.kernels import build
        from repro_torch.kernels.ssd_scan import ssd_scan as kd
        from repro_torch.launch.steps import make_prefill_step
        from repro_torch.models import ssm

        torch, cfg = self.torch, self.cfg
        tokens = self._tokens(LM_TIMED, 6)
        prefill = make_prefill_step(cfg)
        prefill(self.params, {"tokens": tokens})
        torch.cuda.synchronize()
        build.reset_launch_counts()
        logits = prefill(self.params, {"tokens": tokens})
        counts = self._counts()
        torch.cuda.synchronize()
        if counts != self._expect(cfg.n_layers):
            raise AssertionError(f"lm prefill_32k: launch counts {counts}")
        lg = logits.float()
        if (tuple(lg.shape) != (LM_TIMED[0], cfg.vocab)
                or not bool(torch.isfinite(lg).all())):
            raise AssertionError("lm prefill_32k: logits not finite or not"
                                 " of the expected shape")
        spans = []
        real = ssm.ssd_scan

        def timed(*a, chunk):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = real(*a, chunk=chunk)
            ev[1].record()
            spans.append(ev)
            return out

        fwd_ms, ssd_ms = [], []
        for _ in range(3):
            spans.clear()
            ssm.ssd_scan = timed
            try:
                t0 = time.perf_counter()
                prefill(self.params, {"tokens": tokens})
                torch.cuda.synchronize()
                fwd_ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                ssm.ssd_scan = real
            ssd_ms.append(sum(a.elapsed_time(b) for a, b in spans))
        ms = statistics.median(fwd_ms)
        n_tok = LM_TIMED[0] * LM_TIMED[1]
        row = dict(cell=f"prefill bf16 {LM_TIMED[0]}x{LM_TIMED[1]} (prefill_32k)",
                   launches=counts[kd.SSD_SCAN.symbol],
                   max_abs_logit=float(lg.abs().max()),
                   forward_ms=ms, forward_ms_runs=fwd_ms,
                   tokens_per_s=n_tok / ms * 1e3,
                   ssd_call_device_ms=statistics.median(ssd_ms),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        print("lm " + json.dumps(row), flush=True)
        self.summary["prefill_32k_bf16"] = row
        return row

    def time_kernel(self, layers, kd) -> dict:
        """The 48 layers' bare launches as one span behind a device spin
        (median of the spans), into buffers made beforehand, and the 48
        wrapper calls as the path makes them (no spin)."""
        torch = self.torch
        x0 = layers[0]["args"][0]
        y = torch.empty_like(x0)
        state = torch.empty_like(layers[0]["state"])
        stream = torch.cuda.current_stream().cuda_stream

        def bare():
            for lay in layers:
                kd.launch(*lay["args"], y, state, lay["chunk"], stream=stream)

        ms = _median_ms(bare, torch)
        if not (torch.equal(y, layers[-1]["y"])
                and torch.equal(state, layers[-1]["state"])):
            raise AssertionError("lm: the bare launch disagrees with the"
                                 " wrapper's")
        call_ms = _median_ms(
            lambda: [kd.ssd_scan_kernel(*lay["args"], chunk=lay["chunk"])
                     for lay in layers], torch, spin=False)
        return dict(ms=ms, call_ms=call_ms)

    def bound(self, layers) -> dict:
        """The least time of the 48 launches.  Per chunk and sequence the
        function sums over k <= q only, Q(Q+1)/2 of the Q^2 pairs: 2 N
        Q(Q+1)/2 FLOPs for the scores and H 2 P Q(Q+1)/2 for the diagonal
        blocks, then H 2 Q N P for the state's output term and as many for
        the state update, each product once, at the peak rate of x's type
        (bf16 on the tensor cores, as the pyramid bound takes its dtype's);
        against x, y, B, C, dt, A, D read or written once and the final
        state written once, at the HBM rate.  ``ops_ms_f32`` prices the
        same FLOPs at the float32 rate, as the bound did before the
        products moved to the tensor cores."""
        flops = nbytes = 0
        for lay in layers:
            x, dt, A, B, C, D = lay["args"]
            b, S, H, P = x.shape
            N, Q = B.shape[-1], lay["chunk"]
            tri = Q * (Q + 1) // 2
            per = 2 * N * tri + H * 2 * P * tri + 2 * H * 2 * Q * N * P
            flops += b * (S // Q) * per
            nbytes += (2 * x.numel() * x.element_size()
                       + (B.numel() + C.numel()) * B.element_size()
                       + (dt.numel() + A.numel() + D.numel()) * 4
                       + lay["state"].numel() * 4)
        dtype = str(layers[0]["args"][0].dtype).removeprefix("torch.")
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
        return dict(bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
                    ops_ms=ops_ms,
                    ops_ms_f32=flops / PEAK_FLOPS["float32"] * 1e3,
                    gflop_per_layer=flops / len(layers) / 1e9,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")

    def recurrence_f32(self) -> dict:
        """Check 2: at f32, the last position's logits of the prefill
        through kernel D against 512 decode steps over the same prompt,
        which run ``ssd_decode_step`` and no kernel."""
        import dataclasses

        from repro_torch.kernels import build
        from repro_torch.kernels.ssd_scan import ssd_scan as kd
        from repro_torch.launch.steps import make_decode_step, make_prefill_step
        from repro_torch.models.model import init_params
        from repro_torch.models.serving import init_caches

        torch = self.torch
        cfg = dataclasses.replace(self.cfg, dtype="float32")
        params = init_params(cfg, 0, device=self.device)
        b, T = LM_RECURRENCE
        tokens = self._tokens((b, T), 4)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        want = make_prefill_step(cfg)(params, {"tokens": tokens})
        counts = self._counts()
        torch.cuda.synchronize()
        if counts != self._expect(cfg.n_layers):
            raise AssertionError(f"lm f32 prefill: launch counts {counts}")
        step = make_decode_step(cfg)
        caches = init_caches(cfg, b, T, device=self.device)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        for t in range(T):
            got, caches = step(params, tokens[:, t:t + 1], caches, t)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / T
        if self._counts() != self._expect(0):
            raise AssertionError(f"lm decode launched a kernel: {self._counts()}")
        err = float((got - want).abs().max())
        tol = _recurrence_tol(want)
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"lm f32: prefill through {kd.SSD_SCAN.symbol}"
                                 f" vs {T} decode steps, err {err} > tol {tol}")
        row = dict(cell=f"prefill f32 {b}x{T} vs {T} decode steps",
                   launches=counts[kd.SSD_SCAN.symbol],
                   logits_max_abs_err=err, tol=tol,
                   max_abs_logit=float(want.abs().max()),
                   decode_ms_per_token=dec_ms)
        print("lm " + json.dumps(row), flush=True)
        self.summary["recurrence_f32"] = row
        return row

    def serve(self) -> dict:
        """Check 3: ``serve`` at full width and bf16 answers its requests
        with valid token ids."""
        from repro_torch.launch.serve import serve

        gen, tps = serve(LM_ARCH, reduced=False, device=self.device,
                         **LM_SERVE)
        want = (LM_SERVE["batch"], LM_SERVE["new_tokens"])
        if (tuple(gen.shape) != want or int(gen.min()) < 0
                or int(gen.max()) >= self.cfg.vocab):
            raise AssertionError(f"lm serve: tokens {tuple(gen.shape)} in"
                                 f" [{int(gen.min())}, {int(gen.max())}]")
        row = dict(cell="serve bf16", **LM_SERVE, tokens_per_s=tps)
        print("lm " + json.dumps(row), flush=True)
        self.summary["serve_bf16"] = row
        return row

    def run(self) -> dict:
        """The three checks; returns kernel D's entry of the kernels line."""
        from repro_torch.kernels.ssd_scan import ssd_scan as kd

        pre = self.prefill_bf16()
        self.torch.cuda.empty_cache()
        full = self.prefill_full()
        del self.params
        self.torch.cuda.empty_cache()
        rec = self.recurrence_f32()
        self.torch.cuda.empty_cache()
        self.serve()
        return dict(
            name=kd.SSD_SCAN.symbol, route="cuda", source=kd.SSD_SCAN.source,
            replaces=kd.SSD_SCAN.replaces, launches=pre["launches"],
            launches_per_forward={pre["cell"]: pre["launches"],
                                  full["cell"]: full["launches"],
                                  rec["cell"]: rec["launches"]},
            max_abs_err=max(pre["y_max_abs_err"], pre["state_max_abs_err"],
                            pre["f32_layer0_y_max_abs_err"],
                            pre["f32_layer0_state_max_abs_err"],
                            pre["slow_decay_y_max_abs_err"],
                            pre["slow_decay_state_max_abs_err"],
                            pre["slow_decay_carry_max_abs_err"]),
            ms=pre["ms"], call_ms=pre["call_ms"], plain_ms=pre["plain_ms"],
            bound_ms=pre["bound_ms"], bound_by=pre["bound_by"],
            ops_ms_f32=pre["ops_ms_f32"], f32_layer0_ms=pre["f32_layer0_ms"],
            # no single PyTorch call computes the SSD chunk scan
            library_ms=None,
        )


# ---- phase ops ------------------------------------------------------------

# the phase 3 forwards the ops phase runs traced and guarded; the faults
# are injected into the first
OPS_RUNS = ("resnet18/float32/b1", "vgg16/float32/b1")
OPS_REPS = 3


class Ops:
    """The CNN forward observed and guarded (``repro_torch.obs``,
    ``repro_torch.robust``) on phase 3's plans, params and images."""

    def __init__(self, smoke, out_dir: Path):
        self.torch = smoke.torch
        self.out_dir = out_dir
        out_dir.mkdir(parents=True, exist_ok=True)
        self.card = self.torch.cuda.get_device_name(0)
        self.runs = [r for r in smoke.runs if r["key"] in OPS_RUNS]
        self.summary = {}

    def _counts(self):
        from repro_torch.kernels import build

        return {k.symbol: k.launches for k in build.KERNELS}

    @staticmethod
    def _kernel(pyr) -> str:
        from repro_torch.kernels.fused_conv import fused_conv as fc

        return (fc.PYRAMID_KTILED if pyr.launch.c_tiles > 1
                else fc.PYRAMID).symbol

    def _plan_counts(self, plan):
        want = {k: 0 for k in self._counts()}
        for pyr in plan.pyramids:
            want[self._kernel(pyr)] += 1
        return want

    def _check_logits(self, run, logits, ref, what) -> float:
        err = float((logits.float() - ref).abs().max())
        tol = _tol(ref, "float32")
        if not err <= tol:
            raise AssertionError(f"ops {run['key']} {what}: logits max abs"
                                 f" err {err} > tol {tol}")
        return err

    def traced(self, run) -> dict:
        """``OPS_REPS`` traced forwards in one collector: per forward a
        span per launch with a positive CUDA-event time on this card,
        logits and skip maps as the untraced forward's, one run_network
        event, end_skip_counts equal to the skip maps."""
        from repro_torch.net.runner import run_network
        from repro_torch.obs import tracing

        torch, plan = self.torch, run["plan"]
        err = 0.0
        with tracing() as col:
            for _ in range(OPS_REPS):
                logits, skips = run_network(run["x"], run["prepared"],
                                            plan=plan)
                err = max(err, self._check_logits(
                    run, logits, run["logits"].float(), "traced vs untraced"))
                for name, skip in skips.items():
                    if not torch.equal(skip, run["skips"][name]):
                        raise AssertionError(f"ops {run['key']}: traced skip"
                                             f" map of {name} differs")
        torch.cuda.synchronize()
        names = [s.name for s in col.spans]
        if names != [p.name for p in plan.pyramids] * OPS_REPS:
            raise AssertionError(f"ops {run['key']}: spans {names}")
        if not all(s.duration_ms > 0 and s.device == self.card
                   for s in col.spans):
            raise AssertionError(f"ops {run['key']}: a span without a"
                                 " positive time on this card")
        if [e.name for e in col.events].count("run_network") != OPS_REPS:
            raise AssertionError(f"ops {run['key']}: not one run_network"
                                 " event a forward")
        counted = [e.args for e in col.events if e.name == "end_skip_counts"]
        if len(counted) != OPS_REPS * plan.n_launches():
            raise AssertionError(f"ops {run['key']}: {len(counted)}"
                                 " end_skip_counts events")
        for args in counted:
            skip = run["skips"][args["launch"]]
            if (args["per_level"] != skip.sum(dim=(0, 1, 2)).tolist()
                    or args["cells"] != skip[..., 0].numel()):
                raise AssertionError(f"ops {run['key']}: end_skip_counts of"
                                     f" {args['launch']} != its skip map")
        run["ops_collector"] = col
        return dict(spans=len(col.spans), logits_max_abs_err=err,
                    span_ms_per_forward=sum(
                        s.duration_ms for s in col.spans) / OPS_REPS)

    def chrome_trace(self) -> dict:
        """Both traced forwards in one Chrome trace, validated and written;
        the drift report printed."""
        from repro_torch.obs import TraceCollector
        from repro_torch.obs.report import (
            drift_report,
            drift_rows_from_spans,
            format_report,
        )
        from repro_torch.obs.timeline import chrome_trace, write_chrome_trace

        col = TraceCollector()
        launches = []
        for run in self.runs:
            col.spans += run["ops_collector"].spans
            col.events += run["ops_collector"].events
            launches += [(f"{run['key']}/{p.name}", p.launch)
                         for p in run["plan"].pyramids]
        trace = chrome_trace(col, launches=launches)
        path = self.out_dir / "chip_smoke_trace.json"
        write_chrome_trace(str(path), trace)  # validates, raises if invalid
        print(f"ops chrome trace: {len(trace['traceEvents'])} events,"
              " valid", flush=True)
        rep = drift_report(drift_rows_from_spans(col.spans))
        format_report(rep, lambda line: print("ops drift " + line),
                      measured_on=self.card)
        return dict(events=len(trace["traceEvents"]),
                    median_ratio=rep["median_ratio"],
                    flagged=rep["flagged"])

    def guarded(self, run, *, faults=None, params=None):
        """One guarded forward with the launch counts reset just before and
        read just after; ``faults(injector)`` arms a fresh injector.
        Returns (logits, skips, report, counts)."""
        from repro_torch.kernels import build
        from repro_torch.net.runner import run_network
        from repro_torch.robust import GuardConfig, guarding, inject

        params = run["prepared"] if params is None else params
        self.torch.cuda.synchronize()
        build.reset_launch_counts()
        with guarding(GuardConfig(), source_params=run["params"]) as guard:
            with inject(seed=0) as inj:
                if faults is not None:
                    faults(inj)
                logits, skips = run_network(run["x"], params,
                                            plan=run["plan"])
        self.torch.cuda.synchronize()
        return logits, skips, guard.last_report, self._counts()

    def clean(self, run) -> dict:
        """A guarded forward with no fault: every launch clean, no event,
        the kernels launched as the plan says; logits against the port's
        reference_network on the card."""
        from repro_torch.net.runner import reference_network

        logits, skips, rep, counts = self.guarded(run)
        if rep.events or rep.clean_launches != rep.launches:
            raise AssertionError(f"ops {run['key']}: clean guarded run"
                                 f" reported {rep.summary()}")
        want = self._plan_counts(run["plan"])
        if counts != want:
            raise AssertionError(f"ops {run['key']}: guarded launch counts"
                                 f" {counts} != its plan's {want}")
        run["ops_ref"] = reference_network(run["x"], run["graph"],
                                           run["params"])
        run["ops_skips"] = skips
        err = self._check_logits(run, logits, run["ops_ref"], "guarded")
        return dict(launches=counts, clean_launches=rep.clean_launches,
                    logits_max_abs_err=err)

    def fault(self, run, name, arm, *, rung, params=None) -> dict:
        """One injected fault: exactly one event, of ``rung`` (replan:
        replan events only, one of them into >= 2 sub-launches), logits
        within tolerance of reference_network, the skip maps of the
        untouched launches equal the clean run's, and the kernel launches
        the rungs imply (an eager launch none, a replanned one its
        sub-launches, every other launch one), which the report's clean
        launches, sub-launches and quarantined launches add up to."""
        from repro_torch.net.partition import replan_pyramid

        plan = run["plan"]
        logits, skips, rep, counts = self.guarded(run, faults=arm,
                                                  params=params)
        rungs = [e.rung for e in rep.events]
        if not (set(rungs) == {"replan"} and any(
                len(e.detail["sub_launches"]) >= 2 for e in rep.events)
                if rung == "replan" else rungs == [rung]):
            raise AssertionError(f"ops {name}: rungs {rungs}, expected"
                                 f" {rung!r}: {rep.summary()}")
        want = self._plan_counts(plan)
        subs = 0
        for e in rep.events:
            pyr = next((p for p in plan.pyramids if p.name == e.launch),
                       None)
            if e.rung == "eager":
                want[self._kernel(pyr)] -= 1
            elif e.rung == "replan":
                want[self._kernel(pyr)] -= 1
                for sp in replan_pyramid(
                        run["graph"], pyr, vmem_budget=e.detail["budget"],
                        batch=run["batch"], compute_dtype=run["dtype"]):
                    want[self._kernel(sp)] += 1
                    subs += 1
        if counts != want:
            raise AssertionError(f"ops {name}: launch counts {counts} !="
                                 f" {want}")
        if sum(counts.values()) != rep.clean_launches + subs + sum(
                r == "reference" for r in rungs):
            raise AssertionError(f"ops {name}: {sum(counts.values())}"
                                 " kernel launches, not the clean ones plus"
                                 " the sub-launches")
        err = self._check_logits(run, logits, run["ops_ref"], name)
        touched = {e.launch for e in rep.events}
        for key, skip in skips.items():
            if key not in touched and not self.torch.equal(
                    skip, run["ops_skips"][key]):
                raise AssertionError(f"ops {name}: skip map of untouched"
                                     f" launch {key} differs")
        row = dict(rungs=rungs, launches=counts, sub_launches=subs,
                   clean_launches=rep.clean_launches,
                   logits_max_abs_err=err)
        print(f"ops fault {name}: " + json.dumps(row), flush=True)
        return row

    @staticmethod
    def _squeeze(run) -> float:
        """The mildest budget factor that makes the replan rung split a
        launch in two or more: budgets midway between the plan's distinct
        working sets, largest first (the reference chaos suite's rule,
        repeated until a replan splits)."""
        from repro_torch.net.partition import replan_pyramid
        from repro_torch.robust import BudgetError

        plan = run["plan"]
        sizes = sorted({p.launch.vmem_bytes() for p in plan.pyramids},
                       reverse=True)
        for hi, lo in zip(sizes, sizes[1:] + [0]):
            budget = (hi + lo) // 2
            try:
                splits = [len(replan_pyramid(
                    run["graph"], p, vmem_budget=budget, batch=run["batch"],
                    compute_dtype=run["dtype"]))
                    for p in plan.pyramids if p.launch.vmem_bytes() > budget]
            except BudgetError:
                continue
            if max(splits) >= 2:
                return budget / plan.vmem_budget
        raise AssertionError(f"ops {run['key']}: no budget squeeze splits a"
                             " launch")

    def faults(self, run) -> dict:
        """The four fault classes on one forward, each with a fresh
        injector."""
        from repro_torch.robust import corrupt_params

        plan = run["plan"]
        first = plan.pyramids[0].name
        tiled = next(p.name for p in plan.pyramids if p.launch.c_tiles > 1)
        squeeze = self._squeeze(run)
        conv = plan.graph.nodes[1].name
        return {
            "launch_failure": self.fault(
                run, "launch_failure",
                lambda inj: inj.raise_at("run", launch=first),
                rung="eager"),
            "poisoned_output": self.fault(
                run, "poisoned_output",
                lambda inj: inj.poison_output(launch=tiled), rung="reference"),
            "budget_squeeze": self.fault(
                run, "budget_squeeze",
                lambda inj: inj.squeeze_budget(squeeze), rung="replan"),
            "corrupt_params": self.fault(
                run, "corrupt_params", None, rung="heal",
                params=corrupt_params(run["prepared"], conv, seed=3)),
        }

    def latency(self, run) -> dict:
        """Forward latency traced and guarded on phase 3's timer
        (``timed_stats_ms``: median of ``OPS_REPS`` after a warm-up, host
        clock ended by a synchronize) beside phase 3's untraced forward;
        every timed guarded forward checked clean and every timed forward's
        kernel launches counted.  Then the preflight alone, and the
        sentinel reads of one forward's real launch outputs alone: all of
        them, and each output (its elements, its read's ms) by itself."""
        from repro_torch.core.executor import full_fp32
        from repro_torch.kernels import build
        from repro_torch.net.runner import _forward, run_network
        from repro_torch.obs import tracing
        from repro_torch.obs.stats import timed_stats_ms
        from repro_torch.robust import GuardConfig, guarding, preflight
        from repro_torch.robust.guard import sentinel_stats, sentinel_trips

        plan, cfg = run["plan"], GuardConfig()

        def p50_ms(fn):
            return timed_stats_ms(fn, reps=OPS_REPS)["p50_ms"]

        def counted_ms(fn, what):
            self.torch.cuda.synchronize()
            build.reset_launch_counts()
            ms = p50_ms(fn)
            want = {k: v * (OPS_REPS + 1)  # the warm-up and the timed calls
                    for k, v in self._plan_counts(plan).items()}
            if self._counts() != want:
                raise AssertionError(f"ops {run['key']} {what} latency:"
                                     f" launch counts {self._counts()} !="
                                     f" {want}")
            return ms

        def traced():
            with tracing():
                run_network(run["x"], run["prepared"], plan=plan)

        def guarded():
            with guarding(cfg, source_params=run["params"]) as guard:
                run_network(run["x"], run["prepared"], plan=plan)
            rep = guard.last_report
            if rep.events or rep.clean_launches != rep.launches:
                raise AssertionError(f"ops {run['key']}: timed guarded run"
                                     f" reported {rep.summary()}")

        outs = {}

        def keep(pyr, call, x_in):
            y, skip = call()
            outs[pyr.name] = y
            return y, skip

        with full_fp32():
            _forward(run["x"], run["prepared"], plan=plan, end_skip=True,
                     cdt=run["dtype"], launch_wrapper=keep)

        def sentinel(y):
            return lambda: sentinel_trips(sentinel_stats(y),
                                          cfg.magnitude_limit)

        def sentinels():
            for y in outs.values():
                sentinel(y)()

        row = {
            "untraced_ms": run["summary"]["forward_ms"],
            "traced_ms": counted_ms(traced, "traced"),
            "guarded_ms": counted_ms(guarded, "guarded"),
            "preflight_ms": p50_ms(lambda: preflight(
                run["x"], run["prepared"], plan=plan)),
            "sentinel_ms_per_forward": p50_ms(sentinels),
            "sentinel_ms_by_launch": {
                name: [y.numel(), p50_ms(sentinel(y))]
                for name, y in outs.items()},
            "launches": plan.n_launches(),
        }
        row["sentinel_ms_per_launch"] = (
            row["sentinel_ms_per_forward"] / row["launches"])
        row["guarded_extra_ms_per_launch"] = (
            row["guarded_ms"] - row["untraced_ms"]) / row["launches"]
        return row

    def explain(self) -> dict:
        """``python -m repro_torch.obs.explain --model resnet18 --run
        --guard --trace FILE`` as a subprocess on the card."""
        from repro_torch.obs.timeline import validate_chrome_trace

        path = self.out_dir / "explain_trace.json"
        self.torch.cuda.empty_cache()  # the subprocess shares the card
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.explain", "--model",
             "resnet18", "--run", "--guard", "--trace", str(path)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
        )
        for line in out.stdout.splitlines():
            print("ops explain| " + line, flush=True)
        if out.returncode != 0:
            raise AssertionError(f"explain exited {out.returncode}:"
                                 f" {out.stderr[-4000:]}")
        problems = validate_chrome_trace(json.loads(path.read_text()))
        if problems or "no fallbacks" not in out.stdout:
            raise AssertionError(f"explain: {problems or 'fallbacks taken'}")
        return dict(rc=out.returncode, s=time.perf_counter() - t0)

    def run(self) -> dict:
        for run in self.runs:
            row = self.summary.setdefault(run["key"], {})
            row["traced"] = self.traced(run)
        self.summary["chrome_trace"] = self.chrome_trace()
        for run in self.runs:
            self.summary[run["key"]]["guarded"] = self.clean(run)
        self.summary["faults"] = self.faults(self.runs[0])
        for run in self.runs:
            self.summary[run["key"]]["latency"] = self.latency(run)
        self.summary["explain"] = self.explain()
        launches = {f"{r['key']}/guarded": self.summary[r["key"]]["guarded"]
                    ["launches"] for r in self.runs}
        launches.update({f"{self.runs[0]['key']}/{k}": v["launches"]
                         for k, v in self.summary["faults"].items()})
        print("ops launches " + json.dumps(launches), flush=True)
        for run in self.runs:
            print(f"ops {run['key']} " + json.dumps(
                self.summary[run["key"]]), flush=True)
        return self.summary


def _forward_ms(run) -> float:
    """Median host time of a whole forward after a warm-up, each ended by
    a synchronize (``timed_stats_ms``, the ops phase's timer too)."""
    from repro_torch.net.runner import run_network
    from repro_torch.obs.stats import timed_stats_ms

    return timed_stats_ms(
        lambda: run_network(run["x"], run["prepared"], plan=run["plan"]),
        reps=OPS_REPS,
    )["p50_ms"]


def print_build_report(reports, fc, device) -> None:
    """The pyramid kernels', the SOP kernel's and the SSD scan's ptxas
    lines (entry, registers, stack and spills) from this run's build; each
    pyramid kernel's co-resident block count per dtype (the grid of its
    cooperative launch) and the SSD scan's blocks a SM per instance at the
    Mamba-2 model's head width, state and chunk."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan as kd

    for lib in ("fused_pyramid", "online_sop", "ssd_scan"):
        for line in reports.get(lib, "").splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")):
                print(f"ptxas {lib}: {line.strip()}", flush=True)
    for k in fc.KERNELS:
        for name, code in fc._DTYPE_CODES.items():
            print(f"resident blocks {k.symbol} {name}:"
                  f" {k.resident_blocks(code, device)}", flush=True)
    cfg = get_config(LM_ARCH)
    shape = (cfg.ssm_head_dim, cfg.ssm_state, cfg.ssd_chunk)
    for dtype in (torch.bfloat16, torch.float32):
        print(f"resident blocks a SM {kd.SSD_SCAN.symbol} {dtype} at"
              f" (P, N, Q) = {shape}:"
              f" {kd.resident_blocks(*shape, dtype, device)}", flush=True)


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
        print_build_report(reports, fc, device)
        smoke = Smoke(device)
        smoke.phase_pyramids()
        counts = smoke.phase_end_to_end()
        sop = smoke.phase_sop()
        lm = Lm(torch, device)
        ssd = lm.run()
        with tempfile.TemporaryDirectory() as tmp:
            ops = Ops(smoke, Path(tmp) if args.out is None
                      else args.out.parent).run()
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
        kernels.append(ssd)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(dict(
                card=_smi(), kernels=kernels,
                pyramids={s: v["rows"] for s, v in smoke.stats.items()},
                end_to_end=[r["summary"] for r in smoke.runs],
                sop=smoke.sop_rows,
                lm=lm.summary,
                ops=ops,
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
