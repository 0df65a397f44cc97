#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Run from the root of a checkout on a machine with one H100 and nvcc:

    python3 chip_smoke.py [--out FILE.json]

The main path is the paper's contribution, a CNN forward through fused conv
pyramids: the zoo graph (``repro_torch.net.graph``), the auto-partitioner's
cuts (``repro_torch.net.partition.auto_partition``) and the plan-driven
``repro_torch.net.runner.run_network``, one hand-written CUDA pyramid kernel
launch per pyramid; phase ops runs it again traced and guarded.  The second
path is the paper's other half, the digit-serial sum of products with Early
Negative Detection (``repro_torch.kernels.online_sop.online_sop_end``) on
VGG-16's first two conv layers.  The third is the Mamba-2 language model's
prefill and decode, whose prefill runs the SSD chunk scan
(``repro_torch.kernels.ssd_scan.ops.ssd_scan``) once per layer; the fourth
is the Hymba-1.5B hybrid model's (attention and Mamba heads in every
layer), whose prefill runs the same kernel once per layer; the fifth is the
MoE and multi-head latent attention decoders' (Qwen1.5-MoE-A2.7B,
Arctic-480B, MiniCPM3-4B), and the sixth the vision-language and
encoder-decoder models' (Llama-3.2-11B-Vision, Whisper-large-v3); these two
paths hold no kernel.  The seventh is training (``launch.steps.
make_train_step``, ``launch.train.train`` and its CLI), whose Mamba-2 and
Hymba steps run the SSD kernel and its backward kernel inside an autograd
Function.  Phases, any failure exits non-zero:

1. build  — compile every kernel of the four paths from ``src/repro_torch/csrc``
   (one nvcc per source, started together); print the card's name and
   power limit, torch, CUDA and nvcc versions, the pyramid kernels', the
   SOP kernel's, the SSD scan's and its backward's ``ptxas`` lines
   (registers, stack, spills), the pyramid
   kernels' co-resident block count per dtype and the SSD scan's blocks a
   SM per instance at the Mamba-2 and Hymba models' (P, N, Q).
2. pyramids — for every pyramid of the four plans below, the kernel against
   its plain PyTorch version on the card, on dense inputs and on sparse
   ones with negative-shifted biases (the END cascade): skip maps must be
   equal and outputs within the tolerance stated at ``_tol``.  Each dense
   pyramid is also timed (the bare kernel, the wrapper call, the plain
   version, a cuDNN chain) and bounded; its row names each level's conv
   tile and the TFLOP/s its bare time makes of the bound's FLOPs.
3. end to end — ``run_network`` at full width (224x224 input, 1000
   classes) for ResNet-18 f32 batch 1 and 8, ResNet-18 bf16 batch 8 and
   VGG-16 f32 batch 1, planned under the reference's TPU budget
   (``REFERENCE_BUDGET``, passed explicitly: kernel B's only route), each
   held against the port's ``reference_network`` on the card (f32 within
   ``_tol``, bf16 within ``bf16_logit_tol``), with every kernel's launch
   count reset just before each forward and checked just after against
   that forward's plan.  That first forward of each runs eagerly and is
   captured into a CUDA graph (the compiled forward,
   ``repro_torch.net.runner``); the timed forwards replay it, and the
   forward issued launch by launch is timed beside them.  Then the same
   four cells and VGG-16 f32 batch 8 planned under the card's budget (the
   default, ``CARD_BUDGET``, the L2): every pyramid against its plain
   version, timed and bounded as in phase 2 (its rows carry the run's
   ``@card`` key), every forward counted and checked the same way, a
   ``card launch`` line per launch (Q, alpha, cells, card bytes, modeled
   HBM bytes) and an ``end to end card`` line per cell with its replayed
   and eager ms beside the reference-setting plan's and the plan's at
   twice the card's budget; then the fusion sweep (``sweep`` lines):
   kernel A on ResNet-18's first block fused against its two one-conv
   launches, per image, at batches whose fused launch holds 0.25x to 2x
   the L2, and the ``sweep knee`` line: the share before fusion first
   lost, the shares where it paid past that, and the check that fails the
   run unless the card's budget is at most the card's L2 and fusion pays
   on the whole (geometric mean of fused over layerwise below 1) at the
   shares within it; ``phase card: N s``.
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
6. hybrid — Hymba-1.5B (``repro_torch.configs.hymba_1_5b``) at full
   width and depth, random weights from a seed, through the same entry
   points: phase lm's checked bf16 prefill of 4 x 4096 (chunked attention,
   32 counted launches of the SSD kernel, every layer's result against
   ``ssd_scan_plain``, layer 0 at f32 and with a slowly decaying state,
   the kernel timed and bounded at Hymba's heads (H, P, N) = (50, 64, 16));
   the bf16 prefill of 16 of the prefill_32k cell's 32 sequences of 32,768
   tokens, counted and timed (tokens/s, peak memory, the SSD calls'
   share); decode ms per
   step at bf16, batch 4; ``serve`` at bf16 answering 4 requests; at f32,
   one sequence of 4096 tokens through chunked attention against its first
   2048 through dense attention, and 2 sequences of window + 64 tokens
   prefilled against as many decode steps (every position, the window and
   the attention caches in the decode path), each within
   ``_recurrence_tol``; phi-4-mini at full width and 4 layers, f32, its
   prefill of 2 x 1024 against 1024 decode steps.
7. moe — Qwen1.5-MoE-A2.7B (``repro_torch.configs.qwen2_moe_a2_7b``) at
   full width and depth, Arctic-480B at full width and 1 of its 35 layers,
   MiniCPM3-4B at full width and depth, random weights from a seed, each
   freed before the next, through the same entry points; every forward's
   launch counts stay 0 (no kernel lies on these paths).  Qwen: layer 0's
   MoE input captured from the bf16 prefill of 4 x 4096, routed once on
   the card and dispatched both by the port (``dispatch_combine`` and the
   expert einsums, at f32 from f32 copies of the expert weights) and by
   ``moe_loop_reference``, a token-by-token loop of the capacity rule: the
   dropped claims must be the same set and the outputs within
   ``MOE_F32_TOL``; the bf16 prefill of 4 x 4096 (median of 3 after a
   counted forward) and of 8 of the prefill_32k cell's 32 sequences of
   32,768 tokens (``MOE_TIMED_REPS`` timed forwards, one), each with its
   peak memory
   and ``moe_ffn``'s share by CUDA events; decode ms a step at bf16,
   batch 4; ``serve``; 4 layers at f32 with capacity factor E / k (no
   drops), the forward of 2 x 512 against 512 decode steps at every
   position within ``_recurrence_tol``.  Arctic: the same dispatch check
   at bf16 (``MOE_BF16_TOL``), the layer's output minus its attention and
   routed parts against the dense residual MLP, the timed prefill of
   4 x 4096, decode and ``serve`` of the one layer.  MiniCPM3: the timed
   prefill of 4 x 4096 (chunked MLA), decode with the latent cache's bytes
   a token beside a GQA cache's of the same heads, ``serve``, at f32 one
   sequence of 4096 through chunked MLA against its first 2048 through
   dense MLA (62 layers), and 4 layers' forward of 2 x 1024 against 1024
   decode steps.  Each check prints one ``moe {...}`` or ``mla {...}``
   line.
8. vlm — Llama-3.2-11B-Vision (``repro_torch.configs.llama32_vision_11b``)
   and Whisper-large-v3 at full width and depth, random weights from a
   seed, the cross layers' gates set to ``VLM_GATE`` (their zero init would
   hide the cross path), random bf16 stubs for the vision tower and the
   audio front end, through the same entry points; every forward's launch
   counts stay 0.  Llama: the bf16 prefill of 4 x 4096 with a vision stub
   (median of 3 after a counted forward) with its peak memory and
   ``cross_attn_block``'s share by CUDA events; layer 0's cross layer at
   f32 on 4096 queries, which must take the chunked path on its grid
   (1024-query chunks, the 1601-wide source one block), held against
   ``dense_attention`` on the same q, k and v (``plain_tol``); the bf16
   logits of 1 x 512 tokens under two vision stubs, which must differ by
   more than ``VLM_MOVE_SHARE`` of their magnitude; decode ms a step at
   bf16, batch 4, after ``prefill_cross_caches``; ``serve``; 10 of its 40
   layers at f32, the forward of 2 x 512 against 512 decode steps within
   ``_recurrence_tol``.  Whisper: the encoder alone over 4 x 1500 frames;
   the bf16 prefill of 4 x 4096 decoder tokens with the encoder included
   (timed as Llama's); the cross check against a 1500-wide source; decode;
   ``serve``; 4 encoder and 4 decoder layers at f32, prefill against
   decode.  Each check prints one ``vlm {...}`` or ``encdec {...}`` line.
9. train — through the port's training entry points, each check a
   ``train {...}`` line, ending with a ``phase train: N s`` line.  Kernel
   D's Function on layer 0's SSD inputs of an f32 Mamba-2-780m forward at
   full width (2 x 4096, 4 layers), under random upstream gradients: one
   counted launch of D and one of its backward, ``y`` and state within
   ``plain_tol``, every input's gradient within ``plain_tol`` of
   ``ssd_scan_bwd_plain`` and, against float64 autograd, within 4 times
   plain float32 autograd's own error plus 1e-6 of its magnitude, and a
   second backward launch equal bit for bit.  The cell:
   Mamba-2-780m at full width and depth, bf16, remat full, float32
   moments, ``make_train_step(cfg, microbatches=2)`` on ``batch_at`` of 8
   x 4096 tokens (``train_4k``'s sequence, its batch of 256 cut to 8): a
   warm-up step and 3 timed (host clock ending in a synchronize), each
   with 192 counted launches of D (48 layers x 2 for the remat recompute
   x 2 microbatches) and 96 of its backward, and its peak memory, step 0's
   loss against the cross-entropy of ``forward``'s whole logits in f32
   (1e-3 relative), the params unchanged by step 0 (its learning rate is
   0) and moved by step 1, D's forward calls, its backward calls,
   ``chunked_ce`` and the update timed by CUDA events; D at the step's
   shapes against its plain version, its 192 launches timed bare and
   bounded; D's backward at the step's shapes (a random bf16 gradient of
   y, none of the state) against ``ssd_scan_bwd_plain`` (``plain_tol`` at
   each gradient's type), twice equal bit for bit, its 96 launches timed
   bare and as wrapper calls, its eight kernels' device times by
   ``torch.profiler``, the plain version's 96 calls, the bound.
   Then at full width and 4 of
   48 layers, f32, 2 x 512 tokens: two steps on the card against the same
   two on the CPU (losses and step 1's gradients per leaf within 1e-4),
   and ``train`` in-process for 6 steps with a checkpoint at step 3,
   resumed (the replayed last loss within 1e-4 relative); Hymba-1.5B at
   full width and 4 of its 32 layers (global 0 and 3, sliding 1 and 2),
   bf16, two steps of 2 x 4096 through the chunked attention (every
   leaf's gradient finite and non-zero, 8 launches of D and 4 of its
   backward a step, at Hymba's state of 16); and
   ``python -m repro_torch.launch.train --arch deepseek_7b --steps 3`` as a
   subprocess.
10. ops — phase 3's ResNet-18 f32 and VGG-16 f32 batch-1 forwards (their
   reference-budget plans; ``explain`` runs with ``--budget reference``)
   observed and guarded (``repro_torch.obs``, ``repro_torch.robust``): each traced
   launch by launch (``tracing(launches=True)``) three times (per forward a span per launch with a positive CUDA-event
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
11. serve — ResNet-18 at full width (224x224x3, 1000 classes, phase 3's
   params) through the serving engine (``repro_torch.net.serve``,
   ``ServeConfig(buckets=(1, 2, 4, 8), budget=REFERENCE_BUDGET)``, f32;
   the serve CLI with ``--budget reference``): two waves of the same
   seeded stream of 24 requests of 1-3 images, every request's logits
   against ``reference_network`` on its own rows (``_tol``), wave 1
   capturing one CUDA graph a bucket and wave 2 none (no plan, partition
   or capture miss), A's and B's launches equal to the served plans'
   launches per batch; per bucket the replayed forward against the eager
   one bit for bit, b - 1 real rows padded against the same rows unpadded
   (``_tol``, skip maps equal), the replay, the eager forward and the
   pinned staging copy timed (median of 5 after a warm-up), the waves'
   p50/p95 latency and images/s; one bf16 engine at bucket 8
   (``bf16_logit_tol``); a deadline-aware engine under an overload burst
   (some requests shed typed, every admitted one on time or typed); the
   four ``INJECT_MODES`` (breaker 1, watchdog 3, the sentinel for
   ``poison``), each ending every request in a result or a typed error
   with its launches counted; ``ServingFrontend`` hammered by 4 producer
   threads x 8 requests (every handle resolves exactly once); and
   ``python -m repro_torch.net.serve --model resnet18 --requests 32``
   as subprocesses, ``--dry-stream`` and ``--inject slow_launch
   --breaker 1 --watchdog 3``.  Its launches go on a ``serve launches``
   line of their own.
12. examples — the port's four examples run as a user runs them, one
   subprocess each (``python examples/torch_*.py`` with
   ``PYTHONPATH=src``, on the card, reusing ``build/``), each exiting 0
   with its lines parsed and checked: ``torch_quickstart.py`` (alpha 5,
   13.75 us and 86.10 GOPS from the paper's cycle model, fused against
   reference within 1e-5); ``torch_fused_cnn_inference.py`` on LeNet-5,
   AlexNet, VGG-16 and ResNet-18 at the zoo's full size in f32, ResNet-18
   and VGG-16 in bf16 (card budget, ``EXAMPLES_FUSED``): logits within
   the example's limit (f32 ``1e-4 * max(1, max|logit|)``,
   ``bf16_logit_tol``) on dense and sparse input, kernel A's launches a
   forward equal to the plan's, and END cells skipped on LeNet-5 and
   VGG-16 at both dtypes, whose smallest-region plans hold a launch of two
   or more convs over a grid finer than the image (each run an
   ``examples fused {...}`` line); ``torch_serve_lm.py`` (three
   rates > 0); ``torch_train_lm.py`` (``EXAMPLES_TRAIN_STEPS`` = 200 of
   its 300, cut for the phase's time, in a fresh temporary checkpoint
   directory, the loss falling); ``phase examples: N s``.
13. results — one ``{"kernels": [...]}`` line (for the pyramid kernels
   ``launches`` sums phase 3's nine forwards, the four under the
   reference's budget and the five under the card's,
   ``launches_per_forward`` splits it (``@card`` keys), and every time sums
   the per-launch medians over the dense pyramids of the four
   reference-budget plans, while kernel A's ``card`` sums the same times
   over the five card plans' pyramids; for the SOP kernel ``launches_per_layer`` splits
   the 2 and every time sums the two layers: the median of a layer's
   launch, or the sum of its 64 plain calls' single timed spans; for the
   SSD kernel ``launches`` is the bf16 prefill's 48 and every time covers
   its 48 layers; a second entry of the SSD kernel, ``ssd_scan@hymba_1_5b``,
   holds phase hybrid's 32 launches and times at Hymba's heads, and a
   third, ``ssd_scan@mamba2_780m_train``, phase train's 192 launches a
   step with their bare time, plain time and bound at the step's shapes;
   ``ssd_scan_bwd@mamba2_780m_train`` holds the backward kernel's 96
   launches a step the same way, its wrapper calls' time beside them;
   each SSD entry names its path under ``path``), then the ``{"ok": true,
   "device": ...}`` line last.

Weights and inputs are random, made from fixed seeds.  The script imports
nothing of JAX and nothing of the reference package ``repro``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
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
# the same cells and VGG-16 batch 8 planned under the card's budget
CARD_CONFIGS = CONFIGS + (("vgg16", "float32", 8),)
# the fusion sweep: ResNet-18's first block (run, first and last node), at
# batches whose fused launch holds these shares of the card's L2; then two
# VGG-16 pyramids at the shares their batches reach
SWEEP_KNEE = ("resnet18/float32/b1", "b0_convA", "b0_convB")
SWEEP_OTHERS = (("CONV3", "POOL2", (0.5, 1.0, 1.5, 2.0)),
                ("CONV8", "POOL5", (1.5, 2.0)))
SWEEP_SHARES = (0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0, 1.25, 1.5, 1.75,
                2.0)
# a fused launch slower per image than its layerwise launches by more than
# this share lost (the timing medians spread by about 1 %); each median
# over SWEEP_REPS timed calls
SWEEP_NOISE = 0.01
SWEEP_REPS = 15
SWEEP_MAX_BATCH = 256
# the times phase 2 and phase card sum over a kernel's timed pyramids
TIMES = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
         "ops_ms")
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
# tensor cores, bf16 and int8 on the tensor cores; one source with the
# port's roofline (chip_smoke.py alone has none, and main() refuses)
if (ROOT / "src" / "repro_torch").is_dir():
    sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch.launch.roofline import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.launch.roofline import PEAK_FLOPS_BY_TYPE as PEAK_FLOPS
except ImportError:
    HBM_BYTES_PER_S = PEAK_FLOPS = None

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


def _median_ms(fn, torch, *, setup=None, spin: bool = True,
               reps: int = REPS) -> float:
    """Median of ``reps`` per-call CUDA-event times after a warm-up.

    ``setup`` runs before each call, outside the timed span.  With
    ``spin`` the span holds the device's time for the call alone; without
    it, it also holds the time the device waits for the host to enqueue
    the call."""
    for _ in range(WARMUP):
        if setup is not None:
            setup()
        fn()
    times = []
    for _ in range(reps):
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

        from repro_torch.core.program import CARD_BUDGET, REFERENCE_BUDGET
        from repro_torch.net.graph import MODELS
        from repro_torch.net.partition import auto_partition
        from repro_torch.net.runner import (
            init_network_params,
            prepare_network_params,
        )

        self.torch = torch
        self.device = device
        # the reference's TPU budget, passed explicitly (kernel B's only
        # route); then the same cells and VGG-16 batch 8 under the card's
        # budget, the default, on the same params and images
        self.runs, self.card_runs = [], []
        masters, images = {}, {}
        for (model, dtype, batch), budget, runs in (
                [(c, REFERENCE_BUDGET, self.runs) for c in CONFIGS]
                + [(c, CARD_BUDGET, self.card_runs) for c in CARD_CONFIGS]):
            graph = MODELS[model](input_size=INPUT_SIZE,
                                  num_classes=NUM_CLASSES)
            if model not in masters:
                masters[model] = init_network_params(graph, seed=0,
                                                     device=device)
            if budget is CARD_BUDGET:
                plan = auto_partition(graph, batch=batch, compute_dtype=dtype)
                assert plan.budget is CARD_BUDGET
            else:
                plan = auto_partition(graph, batch=batch, compute_dtype=dtype,
                                      budget=budget)
            key = f"{model}/{dtype}/b{batch}"
            if key not in images:
                gen = torch.Generator(device=device).manual_seed(1 + batch)
                images[key] = torch.randn(
                    (batch, INPUT_SIZE, INPUT_SIZE, graph.in_channels),
                    generator=gen, device=device)
            runs.append(dict(
                key=key if budget is REFERENCE_BUDGET else key + "@card",
                graph=graph, plan=plan, params=masters[model], dtype=dtype,
                batch=batch, x=images[key],
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
            max_abs_err=0.0, **dict.fromkeys(TIMES, 0.0), rows=[],
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
            # the card plans' pyramids sum apart from the reference's
            tally = (st.setdefault("card", dict.fromkeys(TIMES, 0.0))
                     if run["key"].endswith("@card") else st)
            for k, v in (("ms", ms), ("call_ms", call_ms),
                         ("plain_ms", plain_ms), ("library_ms", library_ms),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms),
                         ("bound_ms", max(bytes_ms, ops_ms))):
                tally[k] += v
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

    def count_forwards(self, runs) -> dict[str, int]:
        """Every forward of ``runs`` once, each counted on its own against
        its plan; returns each kernel's launches summed over them."""
        from repro_torch.kernels import build
        from repro_torch.kernels.fused_conv import fused_conv as fc
        from repro_torch.net.runner import run_network

        totals = {k.symbol: 0 for k in fc.KERNELS}
        for run in runs:
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
        return totals

    def phase_end_to_end(self) -> dict[str, int]:
        """Every forward of the main path under the reference's budget
        once, each counted on its own against its plan; then checked.
        Returns each kernel's launches summed over the forwards."""
        totals = self.count_forwards(self.runs)
        if any(v == 0 for v in totals.values()):
            raise AssertionError(f"a kernel of the path never ran: {totals}")
        for run in self.runs:
            self.check_logits(run)
        return totals

    def logits_err(self, run) -> tuple[float, float]:
        """The forward's logits against the port's ``reference_network``
        on the card: (max abs error, tolerance), raising past it."""
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
        return err, tol

    def check_logits(self, run) -> None:
        err, tol = self.logits_err(run)
        t = _forward_ms(run)
        rows = [r for st in self.stats.values() for r in st["rows"]
                if r["run"] == run["key"]]
        run["summary"] = dict(
            run=run["key"], launches=run["launches"],
            logits_max_abs_err=err, tol=tol, forward_ms=t,
            eager_forward_ms=_forward_ms(run, eager=True),
            **{f"sum_{k}": sum(r[k] for r in rows) for k in (
                "ms", "call_ms", "bound_ms", "plain_ms", "library_ms")},
        )
        print("end to end " + json.dumps(run["summary"]), flush=True)

    # ---- phase 3, the card's budget ----------------------------------------

    def phase_card(self) -> dict[str, int]:
        """The main path's cells planned under the card's budget (the
        default): every pyramid against its plain version, every forward
        counted against its plan, its logits checked and its replayed and
        eager forwards timed beside the reference-setting plan's; then the
        fusion sweep that checks the budget.  Returns each kernel's
        launches summed over the forwards."""
        from repro_torch.kernels.fused_conv import fused_conv as fc

        t0 = time.perf_counter()
        for ri, run in enumerate(self.card_runs):
            for pi, pyr in enumerate(run["plan"].pyramids):
                self.compare(run, pyr, sparse=False, seed=1000 + 100 * ri + pi,
                             time_it=True)
        totals = self.count_forwards(self.card_runs)
        if totals[fc.PYRAMID.symbol] == 0:
            raise AssertionError(f"kernel A never ran on the card's plans:"
                                 f" {totals}")
        for run in self.card_runs:
            self.card_summary(run)
        self.sweep = self.fusion_sweep()
        self.card_s = time.perf_counter() - t0
        print(f"phase card: {self.card_s:.1f} s", flush=True)
        return totals

    def plan_rows(self, plan) -> dict:
        """A plan's launches with what the card's model counts: Q, alpha,
        cells, card bytes, modeled HBM bytes (halo tiles in, output out,
        weights once), each at the plan's batch."""
        b = plan.batch
        rows = [dict(name=p.name, q=p.q_convs, alpha=p.launch.program.alpha,
                     cells=b * p.launch.program.alpha ** 2,
                     c_tiles=p.launch.c_tiles,
                     card_bytes=p.launch.card_bytes(b),
                     hbm_bytes=p.launch.program.hbm_bytes(b))
                for p in plan.pyramids]
        return dict(budget=str(plan.budget), n_launches=len(rows),
                    card_bytes_max=max(r["card_bytes"] for r in rows),
                    hbm_bytes=sum(r["hbm_bytes"] for r in rows),
                    launches=rows)

    def card_summary(self, run) -> None:
        """One card-budget cell: its launches, its logits, its replayed and
        eager forwards, its pyramids' summed times, and the same of the
        reference-setting plan (phase 3's run of the cell, or one made here
        for VGG-16 batch 8) and of the plan under twice the card's budget
        where its launches differ."""
        from repro_torch.core.program import REFERENCE_BUDGET
        from repro_torch.net.partition import auto_partition
        from repro_torch.net.runner import prepare_network_params, run_network

        def other(budget, key):
            """The cell under another budget: planned, run, checked and
            timed."""
            plan = auto_partition(run["graph"], batch=run["batch"],
                                  compute_dtype=run["dtype"], budget=budget)
            o = dict(run, key=key, plan=plan,
                     prepared=prepare_network_params(plan, run["params"]))
            o["logits"], _ = run_network(o["x"], o["prepared"], plan=plan)
            self.logits_err(o)
            o["summary"] = dict(forward_ms=_forward_ms(o),
                                eager_forward_ms=_forward_ms(o, eager=True))
            return o

        def brief(o) -> dict:
            return dict({k: v for k, v in self.plan_rows(o["plan"]).items()
                         if k != "launches"},
                        forward_ms=o["summary"]["forward_ms"],
                        eager_forward_ms=o["summary"]["eager_forward_ms"])

        err, tol = self.logits_err(run)
        base = run["key"].replace("@card", "")
        ref = next((r for r in self.runs if r["key"] == base), None)
        if ref is None:
            ref = other(REFERENCE_BUDGET, base)
        # the card's model at twice its budget, where fused scratch spills
        # the L2
        twice = run["plan"].budget.scaled(2)
        names = [p.node_names for p in run["plan"].pyramids]
        l2x2 = auto_partition(run["graph"], batch=run["batch"],
                              compute_dtype=run["dtype"], budget=twice)
        l2x2_row = (dict(same_launches=True)
                    if [p.node_names for p in l2x2.pyramids] == names
                    else brief(other(twice, base + "@l2x2")))
        rows = [r for st in self.stats.values() for r in st["rows"]
                if r["run"] == run["key"]]
        plan = self.plan_rows(run["plan"])
        for row in plan.pop("launches"):
            print(f"card launch {run['key']} " + json.dumps(row), flush=True)
        run["summary"] = dict(
            run=run["key"], launches=run["launches"], **plan,
            logits_max_abs_err=err, tol=tol, forward_ms=_forward_ms(run),
            eager_forward_ms=_forward_ms(run, eager=True),
            **{f"sum_{k}": sum(r[k] for r in rows) for k in (
                "ms", "call_ms", "bound_ms", "plain_ms", "library_ms")},
            reference_plan=brief(ref), l2x2_plan=l2x2_row,
        )
        print("end to end card " + json.dumps(run["summary"]), flush=True)

    def sweep_rows(self, key: str, first: str, last: str, shares) -> list:
        """Kernel A on the nodes ``first``..``last`` of run ``key``'s graph
        (its dtype and params) as one launch at alpha 1 against its
        one-conv launches, per image, at the largest batch whose fused
        launch holds each share of the L2 (its card bytes); each through
        ``fused_pyramid`` (the pad included), device time behind a spin,
        the two outputs compared."""
        import dataclasses

        from repro_torch.core.program import CARD_BUDGET, plan_launch
        from repro_torch.kernels.fused_conv.ops import fused_pyramid
        from repro_torch.net.graph import (
            Segment,
            fusable_segments,
            infer_shapes,
        )
        from repro_torch.net.partition import partition_segment

        torch = self.torch
        l2 = torch.cuda.get_device_properties(self.device).L2_cache_size
        run = next(r for r in self.runs if r["key"] == key)
        graph, params, dtype = run["graph"], run["params"], run["dtype"]
        whole = next(s for s in fusable_segments(graph)
                     if first in [n.name for n in s.nodes])
        names = [n.name for n in whole.nodes]
        src = infer_shapes(graph)[graph.node(first).inputs[0]]
        seg = Segment(nodes=whole.nodes[names.index(first):
                                        names.index(last) + 1],
                      input_size=src.size, in_channels=src.channels,
                      relu=whole.relu)
        unbounded = dataclasses.replace(CARD_BUDGET, nbytes=1 << 62)
        fused = [plan_launch(seg.spec(), unbounded, compute_dtype=dtype)]
        layerwise = partition_segment(seg, budget=unbounded, max_convs=1,
                                      compute_dtype=dtype)
        if fused[0].program.alpha != 1:
            raise AssertionError(f"sweep: {first}..{last} is no alpha-1"
                                 " launch")

        def chain(launches, x):
            y, i = x, 0
            for lp in launches:
                n = len(lp.spec.levels)
                convs = [m.name for m in seg.nodes[i:i + n] if m.op == "conv"]
                y, _ = fused_pyramid(
                    y, [params[m][0] for m in convs],
                    [params[m][1] for m in convs], spec=lp.spec,
                    out_region=lp.out_region, streamed=False, x_slots=1,
                    w_slots=1, c_tiles=1, relu=seg.relu, budget=unbounded,
                    compute_dtype=dtype)
                i += n
            return y

        rows, batches = [], []
        for share in shares:
            # the largest batch within the share (at small batches the
            # split levels' partial sums make the bytes non-monotone)
            batch = max((b for b in range(1, SWEEP_MAX_BATCH + 1)
                         if fused[0].card_bytes(b) <= share * l2), default=1)
            if batch in batches:
                continue
            batches.append(batch)
            gen = torch.Generator(device=self.device).manual_seed(batch)
            x = torch.randn((batch, seg.input_size, seg.input_size,
                             seg.in_channels), generator=gen,
                            device=self.device)
            y_f, y_l = chain(fused, x), chain(layerwise, x)
            err = float((y_f.float() - y_l.float()).abs().max())
            if not err <= _tol(y_l.float(), dtype):
                raise AssertionError(f"sweep {first}..{last} b{batch}: fused"
                                     f" and layerwise differ by {err}")
            f_ms = _median_ms(lambda: chain(fused, x), torch,
                              reps=SWEEP_REPS)
            l_ms = _median_ms(lambda: chain(layerwise, x), torch,
                              reps=SWEEP_REPS)
            rows.append(dict(
                pyramid=f"{key} {first}..{last}", q=fused[0].program.q_convs,
                batch=batch, card_bytes=fused[0].card_bytes(batch),
                l2_share=fused[0].card_bytes(batch) / l2,
                fused_ms_per_image=f_ms / batch,
                layerwise_ms_per_image=l_ms / batch,
                fused_over_layerwise=f_ms / l_ms, max_abs_err=err))
            print("sweep " + json.dumps(rows[-1]), flush=True)
            del x, y_f, y_l
        return rows

    def fusion_sweep(self) -> dict:
        """The sweep that checks the card budget: ResNet-18's first block
        (two 3x3 convs of 64 channels at 56^2) fused against its two
        launches at 0.25x to 2x the L2 (:meth:`sweep_rows`).  The knee is
        the largest share before the first at which the fused launch lost
        (took more time per image than the two, past ``SWEEP_NOISE``, the
        medians' run-to-run spread); the shares past it where fusion paid
        again are printed beside it (a loss at a single batch whose tile
        count fills the grid's last wave unevenly is no L2 effect).  The
        run fails unless the card's budget is at most the card's L2 and
        fusion pays on the whole at the shares within the budget: the
        geometric mean of fused over layerwise there is below 1.  Then two
        of VGG-16's pyramids the budget decides, at the shares their
        batches reach: its second block (``CONV3..POOL2``) and its last six
        levels (``CONV8..POOL5``, 28^2 and 14^2 maps of 512 channels)."""
        import math

        from repro_torch.core.program import CARD_BUDGET

        l2 = self.torch.cuda.get_device_properties(self.device).L2_cache_size
        rows = self.sweep_rows(*SWEEP_KNEE, SWEEP_SHARES)
        lost = [r["fused_over_layerwise"] > 1.0 + SWEEP_NOISE for r in rows]
        loss = lost.index(True) if any(lost) else len(rows)
        knee = rows[loss - 1]["l2_share"] if loss else None
        share = CARD_BUDGET.nbytes / l2
        within = [r["fused_over_layerwise"] for r in rows
                  if r["l2_share"] <= share]
        geomean = (math.exp(sum(map(math.log, within)) / len(within))
                   if within else None)
        out = dict(pyramid=rows[0]["pyramid"], l2_bytes=l2,
                   knee_l2_share=knee,
                   paid_past_knee=[r["l2_share"] for r, x
                                   in zip(rows[loss:], lost[loss:])
                                   if not x],
                   budget_bytes=CARD_BUDGET.nbytes, budget_l2_share=share,
                   fused_over_layerwise_within_budget=geomean,
                   budget_checked=(share <= 1.0 and geomean is not None
                                   and geomean < 1.0))
        print("sweep knee " + json.dumps(out), flush=True)
        if not out["budget_checked"]:
            raise AssertionError(f"the card budget fails the sweep: {out}")
        out["rows"] = rows
        out["others"] = [r for first, last, shares in SWEEP_OTHERS
                         for r in self.sweep_rows("vgg16/float32/b1", first,
                                                  last, shares)]
        return out

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

    TAG = "lm"  # the phase's name on its printed lines
    ARCH = LM_ARCH
    PREFILL = LM_PREFILL
    TIMED = LM_TIMED
    # timed forwards after the counted one; two, for the script's time
    # limit (three runs spread 0.2 % on an H100 80GB HBM3 at 700 W)
    TIMED_REPS = 2

    def __init__(self, torch, device):
        from repro_torch.configs import get_config

        self.torch = torch
        self.device = device
        self.cfg = get_config(self.ARCH)
        self.summary = {}

    def _print(self, row) -> None:
        print(f"{self.TAG} " + json.dumps(row), flush=True)

    def _tokens(self, shape, seed):
        gen = self.torch.Generator(device=self.device).manual_seed(seed)
        return self.torch.randint(0, self.cfg.vocab, shape, generator=gen,
                                  device=self.device)

    def _counts(self):
        from repro_torch.kernels import build

        return {k.symbol: k.launches for k in build.KERNELS}

    def _expect(self, n, bwd=0):
        """Every kernel's expected count: ``n`` of D, ``bwd`` of D's
        backward, 0 of the others."""
        from repro_torch.kernels import build
        from repro_torch.kernels.ssd_scan import ssd_scan as kd

        want = {k.symbol: 0 for k in build.KERNELS}
        want[kd.SSD_SCAN.symbol] = n
        want[kd.SSD_SCAN_BWD.symbol] = bwd
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
        tokens = self._tokens(self.PREFILL, 3)
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
            raise AssertionError(f"{self.TAG} prefill: launch counts {counts},"
                                 f" {len(layers)} layers captured; want"
                                 f" {cfg.n_layers}")
        lg = logits.float()
        if (tuple(lg.shape) != (self.PREFILL[0], cfg.vocab)
                or not bool(torch.isfinite(lg).all())):
            raise AssertionError(f"{self.TAG} prefill: logits {tuple(lg.shape)} not"
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
                raise AssertionError(f"{self.TAG} layer {i}: kernel vs plain y err {ey}"
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
            raise AssertionError(f"{self.TAG} layer 0 at f32: y err {err32} (tol"
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
            cell=f"prefill bf16 {self.PREFILL[0]}x{self.PREFILL[1]}",
            launches=counts[kd.SSD_SCAN.symbol],
            y_max_abs_err=err_y, state_max_abs_err=err_s,
            max_abs_y=mag_y, max_abs_state=mag_s,
            f32_layer0_y_max_abs_err=err32, f32_layer0_state_max_abs_err=serr32,
            f32_layer0_ms=f32_ms,
            **slow,
            logits_vs_plain_forward=float((lg - plain_logits).abs().max()),
            max_abs_logit=float(lg.abs().max()),
            forward_ms=ms, tokens_per_s=self.PREFILL[0] * self.PREFILL[1] / ms * 1e3,
            plain_ms=plain_ms, **timing, **bound,
        )
        self._print(row)
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
            raise AssertionError(f"{self.TAG} slow decay: median chunk decay {median}")
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
                f"{self.TAG} slow decay: y err {ey} (tol {ty}), state err {es} (tol"
                f" {ts}), against the advanced shorter run {ec} (tol {tc})")
        return dict(slow_decay_median_chunk_decay=median,
                    slow_decay_max_abs_y=float(py.float().abs().max()),
                    slow_decay_max_abs_state=float(ps.abs().max()),
                    slow_decay_y_max_abs_err=ey,
                    slow_decay_state_max_abs_err=es,
                    slow_decay_carry_max_abs_err=ec)

    def prefill_full(self) -> dict:
        """The timed cell at bf16, no capture: the launch counts of one
        forward, which is also the warm-up, and the peak memory since just
        before it; then the median host time of ``TIMED_REPS`` forwards,
        with each SSD call's device time taken by CUDA events around it
        (the wrapper's casts and launch; no pad at this length) and its
        share of the forward."""
        from repro_torch.kernels import build
        from repro_torch.kernels.ssd_scan import ssd_scan as kd
        from repro_torch.launch.steps import make_prefill_step
        from repro_torch.models import ssm

        torch, cfg = self.torch, self.cfg
        what = f"{self.TAG} prefill_32k"
        tokens = self._tokens(self.TIMED, 6)
        prefill = make_prefill_step(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        logits = prefill(self.params, {"tokens": tokens})
        counts = self._counts()
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if counts != self._expect(cfg.n_layers):
            raise AssertionError(f"{what}: launch counts {counts}")
        lg = logits.float()
        if (tuple(lg.shape) != (self.TIMED[0], cfg.vocab)
                or not bool(torch.isfinite(lg).all())):
            raise AssertionError(f"{what}: logits not finite or not of the"
                                 " expected shape")
        del logits
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
        for _ in range(self.TIMED_REPS):
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
        n_tok = self.TIMED[0] * self.TIMED[1]
        row = dict(cell=(f"prefill bf16 {self.TIMED[0]}x{self.TIMED[1]}"
                         " (prefill_32k)"),
                   launches=counts[kd.SSD_SCAN.symbol],
                   max_abs_logit=float(lg.abs().max()),
                   forward_ms=ms, forward_ms_runs=fwd_ms,
                   tokens_per_s=n_tok / ms * 1e3,
                   ssd_call_device_ms=statistics.median(ssd_ms),
                   ssd_share=statistics.median(ssd_ms) / ms,
                   peak_gb=peak_gb)
        self._print(row)
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
            raise AssertionError(f"{self.TAG}: the bare launch disagrees with the"
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
            raise AssertionError(f"{self.TAG} f32 prefill: launch counts {counts}")
        step = make_decode_step(cfg)
        caches = init_caches(cfg, b, T, device=self.device)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        for t in range(T):
            got, caches = step(params, tokens[:, t:t + 1], caches, t)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / T
        if self._counts() != self._expect(0):
            raise AssertionError(f"{self.TAG} decode launched a kernel:"
                                 f" {self._counts()}")
        err = float((got - want).abs().max())
        tol = _recurrence_tol(want)
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{self.TAG} f32: prefill through {kd.SSD_SCAN.symbol}"
                                 f" vs {T} decode steps, err {err} > tol {tol}")
        row = dict(cell=f"prefill f32 {b}x{T} vs {T} decode steps",
                   launches=counts[kd.SSD_SCAN.symbol],
                   logits_max_abs_err=err, tol=tol,
                   max_abs_logit=float(want.abs().max()),
                   decode_ms_per_token=dec_ms)
        self._print(row)
        self.summary["recurrence_f32"] = row
        return row

    def serve(self) -> dict:
        """Check 3: ``serve`` at full width and bf16 answers its requests
        with valid token ids."""
        from repro_torch.launch.serve import serve

        gen, tps = serve(self.ARCH, reduced=False, device=self.device,
                         **LM_SERVE)
        want = (LM_SERVE["batch"], LM_SERVE["new_tokens"])
        if (tuple(gen.shape) != want or int(gen.min()) < 0
                or int(gen.max()) >= self.cfg.vocab):
            raise AssertionError(f"{self.TAG} serve: tokens {tuple(gen.shape)} in"
                                 f" [{int(gen.min())}, {int(gen.max())}]")
        row = dict(cell="serve bf16", **LM_SERVE, tokens_per_s=tps)
        self._print(row)
        self.summary["serve_bf16"] = row
        return row

    def run(self) -> dict:
        """The three checks; returns kernel D's entry of the kernels line."""
        pre = self.prefill_bf16()
        self.torch.cuda.empty_cache()
        full = self.prefill_full()
        del self.params
        self.torch.cuda.empty_cache()
        rec = self.recurrence_f32()
        self.torch.cuda.empty_cache()
        self.serve()
        return self.entry(pre, [pre, full, rec])

    def entry(self, pre, rows, name=None) -> dict:
        """Kernel D's entry of the kernels line: its launches in the
        checked bf16 prefill, the launches of every forward of ``rows``,
        its largest error against the plain version and its times and
        bound over that prefill's layers."""
        from repro_torch.kernels.ssd_scan import ssd_scan as kd

        return dict(
            name=name or kd.SSD_SCAN.symbol, path=self.ARCH, route="cuda",
            source=kd.SSD_SCAN.source, replaces=kd.SSD_SCAN.replaces,
            launches=pre["launches"],
            launches_per_forward={r["cell"]: r["launches"] for r in rows},
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


# ---- phase hybrid ---------------------------------------------------------

# Hymba-1.5B at full width and full depth (32 layers, d_model 1600, 25 query
# and 5 KV heads of 64, d_ff 5504, 50 Mamba heads of 64 with state 16, chunk
# 256, window 1024 with global layers 0, 15 and 31, vocab 32001), random
# weights from a seed: phase lm's checks at Hymba's shapes (the checked bf16
# prefill of 4 x 4096 captures some 215 MB a layer, 6.9 GB for the 32), then
# the hybrid path's own.  Cuts: the timed prefill runs 16 of the prefill_32k
# cell's 32 sequences of 32,768 tokens, for memory (on an H100 80GB HBM3 at
# 700 W, 8 sequences peaked at 19.5 GB and took 18.7 s a forward; the 32 ran
# out of memory in layer 0's Mamba gate with 54.2 GB allocated and 23.6 GB
# reserved but free); for the run's time limit, the f32 prefill against
# decode runs 2 sequences of window + 64 tokens, one decode step a token (58
# ms a step there), and the dense check runs phi-4-mini at full width and 4
# of its 32 layers.
HY_ARCH = "hymba_1_5b"
HY_TIMED = (16, 32768)  # bf16: the prefill_32k cell, 16 of its 32 sequences
HY_CHUNKED = 4096  # f32, one sequence: chunked over 4096, dense over 2048
HY_RECURRENCE = 2  # f32: sequences of window + 64 tokens, prefill vs decode
HY_DECODE = dict(batch=4, max_seq=2048, steps=64, warmup=4)  # bf16
DENSE_ARCH = "phi4_mini_3_8b"
DENSE_LAYERS = 4  # of 32, full width
DENSE_TOKENS = (2, 1024)  # f32: one attention chunk, prefill vs decode


class Hybrid(Lm):
    """Phase hybrid: the Hymba-1.5B prefill, decode and serve path of the
    port (kernel D in every layer's prefill, GQA attention with RoPE,
    sliding windows and chunked prefill, SwiGLU), and a dense config's
    prefill against its decode."""

    TAG = "hybrid"
    ARCH = HY_ARCH
    TIMED = HY_TIMED
    # one, for the script's time limit (two runs spread 0.002 % on an H100
    # 80GB HBM3 at 700 W)
    TIMED_REPS = 1

    def _check_counts(self, counts, n, what) -> None:
        if counts != self._expect(n):
            raise AssertionError(f"{self.TAG} {what}: launch counts {counts},"
                                 f" want {n} of D and no other")

    def decode_bf16(self) -> dict:
        """Decode ms per step at bf16 (one token for each of ``batch``
        sequences, attention over the whole ``max_seq`` cache): the mean
        over ``steps`` steps after ``warmup``, ended by a synchronize; no
        kernel launches."""
        from repro_torch.kernels import build
        from repro_torch.launch.steps import make_decode_step
        from repro_torch.models.serving import init_caches

        torch, cfg = self.torch, self.cfg
        b, S = HY_DECODE["batch"], HY_DECODE["max_seq"]
        n, warm = HY_DECODE["steps"], HY_DECODE["warmup"]
        tokens = self._tokens((b, n + warm), 8)
        caches = init_caches(cfg, b, S, device=self.device)
        step = make_decode_step(cfg)
        for t in range(warm):
            step(self.params, tokens[:, t:t + 1], caches, t)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        for t in range(warm, warm + n):
            logits, caches = step(self.params, tokens[:, t:t + 1], caches, t)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        self._check_counts(self._counts(), 0, "decode")
        if not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError(f"{self.TAG} decode: logits not finite")
        row = dict(cell=f"decode bf16 batch {b}, cache {S}", steps=n,
                   ms_per_step=ms, tokens_per_s=b / ms * 1e3)
        self._print(row)
        self.summary["decode_bf16"] = row
        return row

    def chunked_vs_dense(self) -> dict:
        """Check 2: at f32, one sequence of ``HY_CHUNKED`` tokens through
        chunked attention against its first half through dense attention:
        the logits at the shared positions within ``_recurrence_tol``.  The
        window bites in both; the global layers attend to everything."""
        import dataclasses

        from repro_torch.kernels import build
        from repro_torch.models.model import forward, init_params

        torch = self.torch
        cfg = dataclasses.replace(self.cfg, dtype="float32")
        params = self.params32 = init_params(cfg, 0, device=self.device)
        tokens = self._tokens((1, HY_CHUNKED), 7)
        half = HY_CHUNKED // 2
        build.reset_launch_counts()
        chunked, _ = forward(cfg, params, tokens, mode="prefill", chunked=True)
        self._check_counts(self._counts(), cfg.n_layers, "chunked f32")
        build.reset_launch_counts()
        dense, _ = forward(cfg, params, tokens[:, :half], mode="prefill",
                           chunked=False)
        self._check_counts(self._counts(), cfg.n_layers, "dense f32")
        err = float((chunked[:, :half] - dense).abs().max())
        tol = _recurrence_tol(dense)
        if not (err <= tol and bool(torch.isfinite(chunked).all())):
            raise AssertionError(f"{self.TAG} f32: chunked vs dense attention"
                                 f" err {err} > tol {tol}")
        row = dict(cell=f"chunked f32 1x{HY_CHUNKED} vs dense 1x{half}",
                   launches=cfg.n_layers, logits_max_abs_err=err, tol=tol,
                   max_abs_logit=float(dense.abs().max()))
        self._print(row)
        self.summary["chunked_vs_dense_f32"] = row
        return row

    def recurrence_f32(self) -> dict:
        """Check 3: at f32, the prefill of ``window + 64`` tokens (dense
        attention, D once a layer) against as many decode steps over the
        same tokens, every position's logits within ``_recurrence_tol``:
        the sliding window and the attention caches in the decode path, on
        the card.  The decode's seconds include each step's comparison."""
        import dataclasses

        from repro_torch.kernels import build
        from repro_torch.launch.steps import make_decode_step
        from repro_torch.models.model import forward
        from repro_torch.models.serving import init_caches

        torch = self.torch
        cfg = dataclasses.replace(self.cfg, dtype="float32")
        params = self.params32
        b, T = HY_RECURRENCE, cfg.window + 64
        tokens = self._tokens((b, T), 4)
        build.reset_launch_counts()
        want, _ = forward(cfg, params, tokens, mode="prefill")
        self._check_counts(self._counts(), cfg.n_layers, "f32 prefill")
        step = make_decode_step(cfg)
        caches = init_caches(cfg, b, T, device=self.device)
        errs = []
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        for t in range(T):
            got, caches = step(params, tokens[:, t:t + 1], caches, t)
            errs.append((got - want[:, t]).abs().amax())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        self._check_counts(self._counts(), 0, "f32 decode")
        err = float(torch.stack(errs).max())
        tol = _recurrence_tol(want)
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{self.TAG} f32: prefill vs {T} decode steps,"
                                 f" err {err} > tol {tol}")
        row = dict(cell=f"prefill f32 {b}x{T} vs {T} decode steps",
                   launches=cfg.n_layers, logits_max_abs_err=err,
                   last_position_max_abs_err=float(errs[-1]), tol=tol,
                   max_abs_logit=float(want.abs().max()),
                   decode_seconds=seconds,
                   decode_ms_per_token=seconds * 1e3 / T)
        self._print(row)
        self.summary["recurrence_f32"] = row
        return row

    def dense_f32(self) -> dict:
        """Check 4: phi-4-mini at full width and ``DENSE_LAYERS`` layers,
        f32: the prefill step's logits (chunked attention) against the last
        of as many decode steps, within ``_recurrence_tol``; no kernel."""
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.launch.steps import make_decode_step, make_prefill_step
        from repro_torch.models.model import init_params
        from repro_torch.models.serving import init_caches

        torch = self.torch
        cfg = dataclasses.replace(get_config(DENSE_ARCH),
                                  n_layers=DENSE_LAYERS, dtype="float32")
        params = init_params(cfg, 0, device=self.device)
        b, T = DENSE_TOKENS
        gen = torch.Generator(device=self.device).manual_seed(9)
        tokens = torch.randint(0, cfg.vocab, (b, T), generator=gen,
                               device=self.device)
        build.reset_launch_counts()
        want = make_prefill_step(cfg)(params, {"tokens": tokens})
        step = make_decode_step(cfg)
        caches = init_caches(cfg, b, T, device=self.device)
        t0 = time.perf_counter()
        for t in range(T):
            got, caches = step(params, tokens[:, t:t + 1], caches, t)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        self._check_counts(self._counts(), 0, f"{DENSE_ARCH}")
        err = float((got - want).abs().max())
        tol = _recurrence_tol(want)
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{self.TAG} {DENSE_ARCH} f32: prefill vs {T}"
                                 f" decode steps, err {err} > tol {tol}")
        row = dict(cell=(f"{DENSE_ARCH} ({DENSE_LAYERS} of 32 layers) prefill"
                         f" f32 {b}x{T} vs {T} decode steps"),
                   logits_max_abs_err=err, tol=tol,
                   max_abs_logit=float(want.abs().max()),
                   decode_ms_per_token=seconds * 1e3 / T)
        self._print(row)
        self.summary["dense_f32"] = row
        return row

    def run(self) -> dict:
        """The checks in order; returns kernel D's entry of the kernels
        line for this path."""
        from repro_torch.kernels.ssd_scan import ssd_scan as kd

        empty = self.torch.cuda.empty_cache
        pre = self.prefill_bf16()
        empty()
        full = self.prefill_full()
        empty()
        self.decode_bf16()
        del self.params
        empty()
        self.serve()
        empty()
        chunk = self.chunked_vs_dense()
        rec = self.recurrence_f32()
        del self.params32
        empty()
        self.dense_f32()
        empty()
        n = chunk["launches"]
        rows = [pre, full, dict(cell=f"chunked f32 1x{HY_CHUNKED}", launches=n),
                dict(cell=f"dense f32 1x{HY_CHUNKED // 2}", launches=n), rec]
        return self.entry(pre, rows, name=f"{kd.SSD_SCAN.symbol}@{self.ARCH}")


# ---- phase moe ------------------------------------------------------------


def moe_loop_reference(xg, idx, w, p, capacity: int):
    """The MoE dispatch rule written out, independent of the port's
    one-hot dispatch: in each group the claims go in token order, then
    choice order, each expert counts the claims made on it, and a claim
    whose count is at or past ``capacity`` is dropped.  Each kept claim
    adds its weight times its expert's SwiGLU of the token, computed in
    float32 one expert at a time from ``p``'s weights.  ``xg (G, T, d)``,
    ``idx`` and ``w (G, T, k)``.  Returns ``(y (G, T, d) float32, the set
    of dropped claims (g, t, j))``."""
    import torch
    import torch.nn.functional as F

    G, T, k = idx.shape
    E = p["router"].shape[1]
    choice = idx.tolist()
    dropped = set()
    kept = [[] for _ in range(E)]
    for g in range(G):
        count = [0] * E
        for t in range(T):
            for j in range(k):
                e = choice[g][t][j]
                if count[e] < capacity:
                    kept[e].append((g, t, j))
                else:
                    dropped.add((g, t, j))
                count[e] += 1
    x = xg.float()
    y = torch.zeros_like(x)
    for e, claims in enumerate(kept):
        if not claims:
            continue
        gi, ti, ji = (torch.tensor(c, device=x.device) for c in zip(*claims))
        xe = x[gi, ti]
        h = (F.silu(xe @ p["w_gate"][e].float()) * (xe @ p["w_up"][e].float())
             ) @ p["w_down"][e].float()
        y.index_put_((gi, ti), w[gi, ti, ji, None].float() * h,
                     accumulate=True)
    return y, dropped


def dropped_claims(combine, idx) -> set:
    """The claims ``(g, t, j)`` that a combine tensor ``(G, T, E, C)``
    gives no slot of their chosen expert ``idx[g, t, j]``."""
    sel = combine.gather(
        2, idx[..., None].expand(*idx.shape, combine.shape[-1]))
    gone = (sel != 0).sum(dim=-1) == 0
    return {tuple(c) for c in gone.nonzero().tolist()}


# Qwen1.5-MoE-A2.7B at full width and depth (24 layers, d_model 2048, 16
# heads of 128, 60 routed experts of 1408 with top-4, 4 shared experts as
# one SwiGLU of 5632, dispatch groups of 512 tokens, vocab 151,936),
# Arctic-480B at full width and 1 of its 35 layers (d_model 7168, 56 query
# and 8 KV heads of 128, 128 experts of 4864 with top-2, a dense residual
# MLP of 4864, vocab 32,000; cut for memory: one layer with its embedding
# and head is 14.07 B parameters, 28.1 GB at bf16, and init_params draws
# each leaf in float32 beside the bf16 ones, so a second layer's 35.7 GB
# f32 draw of the stacked experts would not fit), and MiniCPM3-4B at full
# width and depth (62 layers, d_model 2560, 40 heads, MLA with q_lora 768,
# kv_lora 256, d_nope 64, d_rope 32, d_v 64, d_ff 6400, vocab 73,448);
# random weights from a seed, bf16 unless a check says f32.  No kernel lies
# on these paths: every forward's launch counts stay 0.
QWEN_ARCH = "qwen2_moe_a2_7b"
ARCTIC_ARCH = "arctic_480b"
ARCTIC_LAYERS = 1  # of 35
MLA_ARCH = "minicpm3_4b"
MOE_PREFILL = (4, 4096)  # bf16: layer 0's dispatch against the loop; timed
MOE_TIMED = (8, 32768)  # bf16: Qwen's prefill_32k cell, 8 of 32 sequences
# after the counted forward; one, for the script's time (cut from 2 when
# phase vlm came; two runs spread 0.2 % on an H100 80GB HBM3 at 700 W)
MOE_TIMED_REPS = 1
MOE_LAYERS = 4  # f32 prefill vs decode: of Qwen's 24 and MiniCPM3's 62
MOE_RECURRENCE = (2, 512)  # f32, Qwen at capacity factor E / k: no drops
MLA_RECURRENCE = (2, 1024)  # f32, MiniCPM3, through the latent cache
MLA_CHUNKED = 4096  # f32, one sequence: chunked over 4096, dense over 2048
MOE_DECODE = dict(batch=4, max_seq=2048, steps=64, warmup=4)  # bf16
# The dispatch check's bound at bf16 (Arctic), relative to max|ref| of the
# float32 loop, with no floor: the reference's fan-in rule counts the
# stacked layer and expert dimensions, so at full width the routed
# experts' outputs are of order 1e-5 to 1e-3, and a floor of 1 would pass
# any output of that size.  bf16 keeps 8 significant bits (unit roundoff u =
# 2^-8 relative).  Each kept term w h rounds w (u), h's intermediates gate,
# silu(gate), up and their product (4u each, before the down projection
# sums them with random signs), h itself (u), and the combined y (u): 8u =
# 2^-5 of the output's size covers them with margin.  A misrouted or
# misweighted claim errs by the output's own size, and the dropped sets are
# compared exactly.
MOE_BF16_TOL = 2.0 ** -5
# At f32 (Qwen) the port and the loop sum the same products in another
# order: 1e-4 of the output's size, as the pyramid checks' f32 bound.
MOE_F32_TOL = 1e-4


class MoePhase:
    """Phase moe: the MoE family (Qwen1.5-MoE-A2.7B, Arctic-480B) and MLA
    (MiniCPM3-4B) through the port's entry points.  Every check prints one
    ``moe {...}`` or ``mla {...}`` line; a failed check raises."""

    def __init__(self, torch, device):
        self.torch = torch
        self.device = device
        self.summary = {"moe": {}, "mla": {}}

    def _print(self, tag, key, row) -> None:
        print(f"{tag} " + json.dumps(row), flush=True)
        self.summary[tag][key] = row

    def _tokens(self, cfg, shape, seed):
        gen = self.torch.Generator(device=self.device).manual_seed(seed)
        return self.torch.randint(0, cfg.vocab, shape, generator=gen,
                                  device=self.device)

    def _params(self, cfg):
        from repro_torch.models.model import init_params

        self.torch.cuda.empty_cache()
        return init_params(cfg, 0, device=self.device)

    def _stubs(self, cfg, batch: int, seed: int) -> dict:
        """The stub inputs a family's forward takes besides its tokens:
        none for these families (phase vlm's take vision or frames)."""
        return {}

    def _span(self, cfg):
        """``(module, name)`` of the function whose calls the timed prefill
        times by CUDA events and reports as a share: the MoE layer's
        ``moe_ffn``; none for MLA."""
        from repro_torch.models import blocks

        return (blocks, "moe_ffn") if cfg.family == "moe" else None

    @staticmethod
    def _no_launches(what) -> None:
        from repro_torch.kernels import build

        counts = {k.symbol: k.launches for k in build.KERNELS}
        if any(counts.values()):
            raise AssertionError(f"{what}: launch counts {counts}; no kernel"
                                 " lies on this path")

    def _check_logits(self, logits, shape, what) -> float:
        lg = logits.float()
        if tuple(lg.shape) != shape or not bool(self.torch.isfinite(lg).all()):
            raise AssertionError(f"{what}: logits {tuple(lg.shape)} not finite"
                                 f" or not {shape}")
        return float(lg.abs().max())

    # ---- checks ----------------------------------------------------------

    def capture_moe_input(self, cfg, params, shape, seed):
        """The bf16 prefill of ``shape`` through ``make_prefill_step``,
        counted (no launches), with layer 0's MoE input captured."""
        from repro_torch.kernels import build
        from repro_torch.launch.steps import make_prefill_step
        from repro_torch.models import blocks

        tokens = self._tokens(cfg, shape, seed)
        seen = []
        real = blocks.moe_ffn

        def recording(p, x, **kw):
            if not seen:
                seen.append(x)
            return real(p, x, **kw)

        self.torch.cuda.synchronize()
        blocks.moe_ffn = recording
        try:
            build.reset_launch_counts()
            logits = make_prefill_step(cfg)(params, {"tokens": tokens})
            self.torch.cuda.synchronize()
        finally:
            blocks.moe_ffn = real
        self._no_launches(f"{cfg.name} prefill")
        self._check_logits(logits, (shape[0], cfg.vocab), f"{cfg.name} prefill")
        return seen[0]

    def dispatch_check(self, cfg, p, xn, *, f32: bool) -> dict:
        """Layer 0's MoE input routed once on the card, then that routing
        through the port's ``dispatch_combine`` and expert einsums (at f32
        from f32 copies of the expert weights, else at the config's bf16)
        and through ``moe_loop_reference``: the dropped claims must be the
        same set, the kept outputs within ``MOE_F32_TOL`` or
        ``MOE_BF16_TOL`` of max|loop|."""
        from repro_torch.models import moe

        torch = self.torch
        b, s, d = xn.shape
        groups = max(1, b * s // cfg.moe_group_tokens)
        tg = b * s // groups
        xg = xn.reshape(groups, tg, d)
        logits = torch.einsum("gtd,de->gte", xg.float(), p["router"].float())
        idx, w = moe.route_topk(logits, cfg.top_k)
        capacity = max(1, int(tg * cfg.top_k * cfg.capacity_factor)
                       // cfg.n_experts)
        pe, xd = p, xg
        if f32:
            pe = {k: p[k].float() for k in ("w_gate", "w_up", "w_down")}
            xd = xg.float()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        disp, comb = moe.dispatch_combine(xd, idx, w, cfg.n_experts, capacity)
        y = torch.einsum("gtec,gecd->gtd", comb, moe.experts(pe, disp))
        torch.cuda.synchronize()
        port_ms = (time.perf_counter() - t0) * 1e3
        del disp, pe
        dropped = dropped_claims(comb, idx)
        del comb
        t0 = time.perf_counter()
        want, want_dropped = moe_loop_reference(xg, idx, w, p, capacity)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        dtype = "f32" if f32 else "bf16"
        what = f"{cfg.name} dispatch {dtype}"
        if dropped != want_dropped:
            raise AssertionError(f"{what}: {len(dropped ^ want_dropped)} claims"
                                 " dropped by one and not the other")
        err = float((y.float() - want).abs().max())
        tol = (MOE_F32_TOL if f32 else MOE_BF16_TOL) * float(want.abs().max())
        if not (err <= tol and tol > 0):
            raise AssertionError(f"{what}: err {err} > tol {tol}")
        return dict(cell=f"dispatch {dtype}, layer 0 of a prefill {b}x{s}",
                    model=cfg.name, groups=groups, capacity=capacity,
                    claims=idx.numel(), dropped=len(dropped),
                    dropped_share=len(dropped) / idx.numel(),
                    max_abs_err=err, tol=tol,
                    max_abs_y=float(want.abs().max()), port_ms=port_ms,
                    loop_s=loop_s)

    def timed_prefill(self, cfg, params, shape, seed, reps) -> dict:
        """A counted forward of ``shape`` through ``make_prefill_step`` (no
        launches; the peak memory since just before it), then the median
        host time of ``reps`` forwards, each call of the family's
        :meth:`_span` function timed by CUDA events around it, and its
        share."""
        from repro_torch.kernels import build
        from repro_torch.launch.steps import make_prefill_step

        torch = self.torch
        batch = {"tokens": self._tokens(cfg, shape, seed),
                 **self._stubs(cfg, shape[0], seed)}
        prefill = make_prefill_step(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        self._no_launches(f"{cfg.name} prefill {shape}")
        mag = self._check_logits(logits, (shape[0], cfg.vocab),
                                 f"{cfg.name} prefill {shape}")
        del logits
        spans = []
        mod, name = self._span(cfg) or (None, "")
        real = None if mod is None else getattr(mod, name)

        def timed(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = real(*a, **kw)
            ev[1].record()
            spans.append(ev)
            return out

        fwd_ms, span_ms = [], []
        for _ in range(reps):
            spans.clear()
            if mod is not None:
                setattr(mod, name, timed)
            try:
                t0 = time.perf_counter()
                prefill(params, batch)
                torch.cuda.synchronize()
                fwd_ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                if mod is not None:
                    setattr(mod, name, real)
            span_ms.append(sum(a.elapsed_time(b) for a, b in spans))
        ms = statistics.median(fwd_ms)
        row = dict(cell=f"prefill bf16 {shape[0]}x{shape[1]}", model=cfg.name,
                   layers=cfg.n_layers, counted_forward_ms=first_ms,
                   forward_ms=ms, forward_ms_runs=fwd_ms,
                   tokens_per_s=shape[0] * shape[1] / ms * 1e3,
                   peak_gb=peak_gb, max_abs_logit=mag)
        if mod is not None:
            row.update({f"{name}_device_ms": statistics.median(span_ms),
                        f"{name}_calls": len(spans),
                        f"{name}_share": statistics.median(span_ms) / ms})
        return row

    def decode(self, cfg, params) -> dict:
        """Decode ms a step at bf16: one token for each of ``batch``
        sequences, attention over the whole ``max_seq`` cache, the mean
        over ``steps`` steps after ``warmup``, ended by a synchronize; no
        launches."""
        from repro_torch.kernels import build
        from repro_torch.launch.steps import make_decode_step
        from repro_torch.models.params import leaves
        from repro_torch.models.serving import init_caches
        from repro_torch.models.serving import prefill_cross_caches

        torch = self.torch
        b, S = MOE_DECODE["batch"], MOE_DECODE["max_seq"]
        n, warm = MOE_DECODE["steps"], MOE_DECODE["warmup"]
        tokens = self._tokens(cfg, (b, n + warm), 8)
        caches = prefill_cross_caches(
            cfg, params, init_caches(cfg, b, S, device=self.device),
            **self._stubs(cfg, b, 8))
        step = make_decode_step(cfg)
        for t in range(warm):
            step(params, tokens[:, t:t + 1], caches, t)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        for t in range(warm, warm + n):
            logits, caches = step(params, tokens[:, t:t + 1], caches, t)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        self._no_launches(f"{cfg.name} decode")
        self._check_logits(logits, (b, cfg.vocab), f"{cfg.name} decode")
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in leaves(caches))
        return dict(cell=f"decode bf16 batch {b}, cache {S}", model=cfg.name,
                    layers=cfg.n_layers, steps=n, ms_per_step=ms,
                    tokens_per_s=b / ms * 1e3,
                    cache_bytes_per_token=cache_bytes / (b * S))

    def serve(self, cfg) -> dict:
        """``serve`` of ``cfg`` at full width and bf16 answers its requests
        with valid token ids."""
        from repro_torch.launch.serve import serve

        self.torch.cuda.empty_cache()
        gen, tps = serve(cfg, reduced=False, device=self.device, **LM_SERVE)
        want = (LM_SERVE["batch"], LM_SERVE["new_tokens"])
        if (tuple(gen.shape) != want or int(gen.min()) < 0
                or int(gen.max()) >= cfg.vocab):
            raise AssertionError(f"{cfg.name} serve: tokens {tuple(gen.shape)}"
                                 f" in [{int(gen.min())}, {int(gen.max())}]")
        return dict(cell="serve bf16", model=cfg.name, layers=cfg.n_layers,
                    **LM_SERVE, tokens_per_s=tps)

    def prefill_vs_decode(self, cfg, shape, seed) -> dict:
        """At f32: the forward's logits at every position (dense attention)
        against as many decode steps over the same tokens, within
        ``_recurrence_tol``; no launches."""
        from repro_torch.kernels import build
        from repro_torch.launch.steps import make_decode_step
        from repro_torch.models.model import forward
        from repro_torch.models.serving import init_caches
        from repro_torch.models.serving import prefill_cross_caches

        torch = self.torch
        params = self._params(cfg)
        b, T = shape
        tokens = self._tokens(cfg, shape, seed)
        stubs = self._stubs(cfg, b, seed)
        build.reset_launch_counts()
        want, _ = forward(cfg, params, tokens, mode="prefill", **stubs)
        step = make_decode_step(cfg)
        caches = prefill_cross_caches(
            cfg, params, init_caches(cfg, b, T, device=self.device), **stubs)
        errs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(T):
            got, caches = step(params, tokens[:, t:t + 1], caches, t)
            errs.append((got - want[:, t]).abs().amax())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        self._no_launches(f"{cfg.name} f32 prefill vs decode")
        err = float(torch.stack(errs).max())
        tol = _recurrence_tol(want)
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{cfg.name} f32: prefill vs {T} decode steps,"
                                 f" err {err} > tol {tol}")
        row = dict(cell=(f"prefill f32 {b}x{T} vs {T} decode steps,"
                         f" {cfg.n_layers} layers"), model=cfg.name,
                   logits_max_abs_err=err,
                   last_position_max_abs_err=float(errs[-1]), tol=tol,
                   max_abs_logit=float(want.abs().max()),
                   decode_ms_per_token=seconds * 1e3 / T)
        if cfg.family == "moe":
            row["capacity_factor"] = cfg.capacity_factor
        return row

    def dense_residual(self, cfg, p, x) -> dict:
        """Arctic's layer on its input ``x``: the output minus the
        attention's and the routed experts' parts equals the dense
        residual MLP on the same normed input.  Two bf16 sums build the
        output, y = routed + dense and x1 + y, each rounded by at most u =
        2^-8 of its size, so the difference errs by at most 2^-7 of the
        largest part; the bound is twice that, 2^-6, and the dense part
        must exceed it twice over for the check to have teeth."""
        from repro_torch.models import blocks as B
        from repro_torch.models.moe import moe_ffn

        ctx = B.LayerCtx(mode="prefill", chunked=True)
        out, _, _ = B.moe_layer(cfg, p, x, ctx)
        xa = B._norm(cfg, x, p["attn_norm"])
        h, _ = B._self_attention(cfg, p["attn"], xa, ctx, None)
        x1 = x + h
        xn = B._norm(cfg, x1, p["ffn_norm"])
        tokens = x.shape[0] * x.shape[1]
        routed, _ = moe_ffn(p["moe"], xn, n_experts=cfg.n_experts,
                            top_k=cfg.top_k,
                            capacity_factor=cfg.capacity_factor,
                            groups=max(1, tokens // cfg.moe_group_tokens))
        dense = B._ffn(cfg, p["dense"], xn)
        rest = out.float() - x1.float() - routed.float()
        err = float((rest - dense.float()).abs().max())
        mag = float(dense.abs().max())
        tol = 2.0 ** -6 * max(1.0, float(out.abs().max()),
                              float(routed.abs().max()) + mag)
        if not (err <= tol and mag > 2 * tol):
            raise AssertionError(f"{cfg.name} dense residual: err {err} (tol"
                                 f" {tol}), max|dense| {mag}")
        return dict(cell="dense residual, layer 0", model=cfg.name,
                    max_abs_err=err, tol=tol, max_abs_dense=mag,
                    max_abs_routed=float(routed.abs().max()),
                    max_abs_out=float(out.abs().max()))

    def chunked_vs_dense(self, cfg) -> dict:
        """At f32, full depth: one sequence of ``MLA_CHUNKED`` tokens
        through chunked MLA against its first half through dense MLA, the
        logits at the shared positions within ``_recurrence_tol``."""
        from repro_torch.kernels import build
        from repro_torch.models.model import forward

        torch = self.torch
        params = self._params(cfg)
        tokens = self._tokens(cfg, (1, MLA_CHUNKED), 7)
        half = MLA_CHUNKED // 2
        build.reset_launch_counts()
        chunked, _ = forward(cfg, params, tokens, mode="prefill", chunked=True)
        dense, _ = forward(cfg, params, tokens[:, :half], mode="prefill",
                           chunked=False)
        self._no_launches(f"{cfg.name} chunked vs dense")
        err = float((chunked[:, :half] - dense).abs().max())
        tol = _recurrence_tol(dense)
        if not (err <= tol and bool(torch.isfinite(chunked).all())):
            raise AssertionError(f"{cfg.name} f32: chunked vs dense MLA err"
                                 f" {err} > tol {tol}")
        return dict(cell=f"chunked f32 1x{MLA_CHUNKED} vs dense 1x{half}",
                    model=cfg.name, layers=cfg.n_layers,
                    logits_max_abs_err=err, tol=tol,
                    max_abs_logit=float(dense.abs().max()))

    # ---- the three models ------------------------------------------------

    def qwen(self) -> None:
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.models.params import tree_map

        cfg = get_config(QWEN_ARCH)
        params = self._params(cfg)
        xn = self.capture_moe_input(cfg, params, MOE_PREFILL, 3)
        p0 = tree_map(lambda t: t[0], params["layers"]["moe"])
        self._print("moe", "qwen_dispatch_f32",
                    self.dispatch_check(cfg, p0, xn, f32=True))
        del xn, p0
        self.torch.cuda.empty_cache()
        self._print("moe", "qwen_prefill_bf16",
                    self.timed_prefill(cfg, params, MOE_PREFILL, 3, 3))
        self.torch.cuda.empty_cache()
        row = self.timed_prefill(cfg, params, MOE_TIMED, 6, MOE_TIMED_REPS)
        row["cell"] += " (prefill_32k)"
        self._print("moe", "qwen_prefill_32k", row)
        self.torch.cuda.empty_cache()
        self._print("moe", "qwen_decode_bf16", self.decode(cfg, params))
        del params
        self._print("moe", "qwen_serve_bf16", self.serve(cfg))
        cut = dataclasses.replace(
            cfg, n_layers=MOE_LAYERS, dtype="float32",
            capacity_factor=cfg.n_experts / cfg.top_k)
        self._print("moe", "qwen_recurrence_f32",
                    self.prefill_vs_decode(cut, MOE_RECURRENCE, 4))

    def arctic(self) -> None:
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.models.params import tree_map

        cfg = dataclasses.replace(get_config(ARCTIC_ARCH),
                                  n_layers=ARCTIC_LAYERS)
        params = self._params(cfg)
        xn = self.capture_moe_input(cfg, params, MOE_PREFILL, 3)
        p0 = tree_map(lambda t: t[0], params["layers"])
        self._print("moe", "arctic_dispatch_bf16",
                    self.dispatch_check(cfg, p0["moe"], xn, f32=False))
        del xn
        self.torch.cuda.empty_cache()
        # the one layer's input is the embedding of the prefill's tokens
        tokens = self._tokens(cfg, MOE_PREFILL, 3)
        x = params["embed"][tokens].to(self.torch.bfloat16)
        self._print("moe", "arctic_dense_residual",
                    self.dense_residual(cfg, p0, x))
        del x, p0
        self.torch.cuda.empty_cache()
        self._print("moe", "arctic_prefill_bf16",
                    self.timed_prefill(cfg, params, MOE_PREFILL, 3, 3))
        self.torch.cuda.empty_cache()
        self._print("moe", "arctic_decode_bf16", self.decode(cfg, params))
        del params
        self._print("moe", "arctic_serve_bf16", self.serve(cfg))

    def minicpm3(self) -> None:
        import dataclasses

        from repro_torch.configs import get_config

        cfg = get_config(MLA_ARCH)
        params = self._params(cfg)
        self._print("mla", "prefill_bf16",
                    self.timed_prefill(cfg, params, MOE_PREFILL, 3, 3))
        self.torch.cuda.empty_cache()
        row = self.decode(cfg, params)
        d_k = cfg.d_nope + cfg.d_rope
        row["gqa_cache_bytes_per_token"] = (
            (d_k + cfg.d_v) * cfg.n_heads * 2 * cfg.n_layers)
        self._print("mla", "decode_bf16", row)
        del params
        self._print("mla", "serve_bf16", self.serve(cfg))
        f32 = dataclasses.replace(cfg, dtype="float32")
        self._print("mla", "chunked_vs_dense_f32", self.chunked_vs_dense(f32))
        self.torch.cuda.empty_cache()
        self._print("mla", "recurrence_f32", self.prefill_vs_decode(
            dataclasses.replace(f32, n_layers=MOE_LAYERS), MLA_RECURRENCE, 4))

    def run(self) -> dict:
        t0 = time.perf_counter()
        for model in (self.qwen, self.arctic, self.minicpm3):
            model()
            self.torch.cuda.empty_cache()
        self.summary["seconds"] = time.perf_counter() - t0
        print(f"phase moe: {self.summary['seconds']:.1f} s", flush=True)
        return self.summary


# ---- phase vlm ------------------------------------------------------------

# Llama-3.2-11B-Vision at full width and depth (40 layers = 8 groups of 4
# dense layers and 1 gated cross-attention layer, d_model 4096, 32 query and
# 8 KV heads of 128, d_ff 14,336, vocab 128,256, a 1601-token vision stub;
# 8.37 B parameters, 16.7 GB at bf16) and Whisper-large-v3 at full width and
# depth (32 encoder and 32 decoder layers, d_model 1280, 20 heads of 64, d_ff
# 5120, vocab 51,866, a 1500-frame stub, LayerNorm and GELU; 1.60 B, 3.2 GB);
# random weights from a seed, bf16 unless a check says f32; the stubs are
# random bf16, as the reference makes them.  The cross layers' gates start
# at zero and tanh(0) = 0 would hide the cross path from every check, so the
# phase sets them to VLM_GATE in the port's params (``serve`` draws its own,
# zero-gated params).  Cuts, for time: the f32 prefill against decode runs
# Llama at 10 of its 40 layers (2 groups) and Whisper at 4 of its 32
# encoder and 4 of its 32 decoder layers.  No kernel lies on these paths:
# every forward's launch counts stay 0.
VLM_ARCH = "llama32_vision_11b"
WHISPER_ARCH = "whisper_large_v3"
VLM_GATE = 1.0  # tanh(1) = 0.76 of each cross layer's output
VLM_PREFILL = (4, 4096)  # bf16: timed, cross-attention's share
VLM_CROSS_Q = 4096  # f32, one cross layer: 4 query chunks of 1024
VLM_MOVE = (1, 512)  # bf16, full depth: two vision stubs
VLM_RECURRENCE = (2, 512)  # f32, prefill vs decode
VLM_LAYERS = 10  # of Llama's 40: 2 groups, f32 prefill vs decode
WHISPER_LAYERS = 4  # of 32 encoder and 32 decoder layers, the same check
WHISPER_ENCODER_BATCH = 4  # the encoder alone over 4 x 1500 frames, bf16
# the vision change must move Llama's bf16 logits by more than this share of
# their magnitude: four bf16 roundings' worth (2^-8 each), which no rounding
# difference reaches, while a live gate moves them by the cross layers' own
# share of the residual stream
VLM_MOVE_SHARE = 2.0 ** -6


class VlmPhase(MoePhase):
    """Phase vlm: the VLM family (Llama-3.2-11B-Vision) and the
    encoder-decoder family (Whisper-large-v3) through the port's entry
    points.  Every check prints one ``vlm {...}`` or ``encdec {...}``
    line; a failed check raises."""

    def __init__(self, torch, device):
        super().__init__(torch, device)
        self.summary = {"vlm": {}, "encdec": {}}

    def _params(self, cfg):
        params = super()._params(cfg)
        if "gate" in params.get("cross", {}):
            params["cross"]["gate"].fill_(VLM_GATE)
        return params

    def _stubs(self, cfg, batch: int, seed: int) -> dict:
        gen = self.torch.Generator(device=self.device).manual_seed(seed)
        n = cfg.vis_seq if cfg.family == "vlm" else cfg.enc_seq
        stub = self.torch.randn((batch, n, cfg.d_model), generator=gen,
                                device=self.device, dtype=self.torch.bfloat16)
        return {"vision" if cfg.family == "vlm" else "frames": stub}

    def _span(self, cfg):
        from repro_torch.models import model

        return model, "cross_attn_block"

    def cross_chunked_vs_dense(self, cfg, params) -> dict:
        """One cross layer (layer 0's weights, at f32) on ``VLM_CROSS_Q``
        queries against the stub's source: the block must take the
        chunked path on its grid (1024-query chunks, the whole source one
        key block), and that output is held against ``dense_attention``
        on the same q, k and v within ``plain_tol`` (1e-4 of max|dense|,
        no floor).  Both dataflows are timed once."""
        import dataclasses

        from repro_torch.kernels import build
        from repro_torch.kernels.ssd_scan.ssd_scan import plain_tol
        from repro_torch.models import blocks as B
        from repro_torch.models.layers import dense_attention
        from repro_torch.models.params import tree_map

        torch = self.torch
        f32 = dataclasses.replace(cfg, dtype="float32")
        cp = tree_map(lambda t: t[0].float(), params["cross"])
        src = next(iter(self._stubs(cfg, 1, 5).values())).float()
        gen = torch.Generator(device=self.device).manual_seed(6)
        x = torch.randn((1, VLM_CROSS_Q, cfg.d_model), generator=gen,
                        device=self.device)
        seen = []
        real = B.chunked_attention

        def recording(q, k, v, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(q, k, v, **kw)
            torch.cuda.synchronize()
            seen.append((q, k, v, kw, out, (time.perf_counter() - t0) * 1e3))
            return out

        build.reset_launch_counts()
        B.chunked_attention = recording
        try:
            B.cross_attn_block(f32, cp, x, src, B.LayerCtx(mode="prefill"))
        finally:
            B.chunked_attention = real
        q, k, v, kw, chunked, chunked_ms = seen[0]
        grid = dict(causal=False, q_chunk=1024, kv_chunk=src.shape[1])
        if len(seen) != 1 or kw != grid:
            raise AssertionError(f"{cfg.name} cross layer: chunked calls"
                                 f" {[s[3] for s in seen]}, want one {grid}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense = dense_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        dense_ms = (time.perf_counter() - t0) * 1e3
        self._no_launches(f"{cfg.name} cross layer")
        err = float((chunked - dense).abs().max())
        tol = plain_tol(dense, torch.float32)
        if not (err <= tol and tol > 0):
            raise AssertionError(f"{cfg.name} cross layer f32: chunked vs"
                                 f" dense err {err} > tol {tol}")
        return dict(cell=(f"cross layer f32 1x{VLM_CROSS_Q} vs a"
                          f" {src.shape[1]}-wide source"), model=cfg.name,
                    grid=[kw["q_chunk"], kw["kv_chunk"]], max_abs_err=err,
                    tol=tol, max_abs_out=float(dense.abs().max()),
                    chunked_ms=chunked_ms, dense_ms=dense_ms)

    def vision_moves(self, cfg, params) -> dict:
        """At bf16 and full depth: the logits of ``VLM_MOVE`` tokens under
        two vision stubs differ by more than ``VLM_MOVE_SHARE`` of their
        magnitude (the gated cross path is live), and a rerun under the
        first stub is printed beside it."""
        from repro_torch.kernels import build
        from repro_torch.models.model import forward

        tokens = self._tokens(cfg, VLM_MOVE, 9)
        stubs = [self._stubs(cfg, VLM_MOVE[0], seed) for seed in (10, 11, 10)]
        build.reset_launch_counts()
        a, b, again = (forward(cfg, params, tokens, mode="prefill", **st)[0]
                       for st in stubs)
        self._no_launches(f"{cfg.name} vision change")
        mag = self._check_logits(a[:, -1], (1, cfg.vocab), cfg.name)
        moved = float((a.float() - b.float()).abs().max())
        rerun = float((a.float() - again.float()).abs().max())
        if not moved > VLM_MOVE_SHARE * mag:
            raise AssertionError(f"{cfg.name}: another vision stub moves the"
                                 f" logits by {moved}, max|logit| {mag}")
        return dict(cell=f"vision change, bf16 {VLM_MOVE[0]}x{VLM_MOVE[1]}",
                    model=cfg.name, gate=VLM_GATE, moved_max_abs=moved,
                    moved_share=moved / mag, bound_share=VLM_MOVE_SHARE,
                    rerun_max_abs=rerun, max_abs_logit=mag)

    def encoder_ms(self, cfg, params) -> dict:
        """Whisper's encoder alone over ``WHISPER_ENCODER_BATCH`` x 1500
        frames at bf16: a counted warm-up, then the median of 3, host
        clock ended by a synchronize."""
        from repro_torch.kernels import build
        from repro_torch.models.model import _whisper_encoder

        torch = self.torch
        frames = self._stubs(cfg, WHISPER_ENCODER_BATCH, 12)["frames"]
        build.reset_launch_counts()
        out = _whisper_encoder(cfg, params, frames)
        torch.cuda.synchronize()
        self._no_launches(f"{cfg.name} encoder")
        if (tuple(out.shape) != tuple(frames.shape)
                or not bool(torch.isfinite(out.float()).all())):
            raise AssertionError(f"{cfg.name} encoder: {tuple(out.shape)}")
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            _whisper_encoder(cfg, params, frames)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(runs)
        return dict(cell=f"encoder bf16 {WHISPER_ENCODER_BATCH}x{cfg.enc_seq}",
                    model=cfg.name, layers=cfg.enc_layers, encoder_ms=ms,
                    encoder_ms_runs=runs,
                    frames_per_s=WHISPER_ENCODER_BATCH * cfg.enc_seq / ms * 1e3)

    # ---- the two models --------------------------------------------------

    def llama(self) -> None:
        import dataclasses

        from repro_torch.configs import get_config

        cfg = get_config(VLM_ARCH)
        params = self._params(cfg)
        self._print("vlm", "prefill_bf16",
                    self.timed_prefill(cfg, params, VLM_PREFILL, 3, 3))
        self.torch.cuda.empty_cache()
        self._print("vlm", "cross_chunked_vs_dense_f32",
                    self.cross_chunked_vs_dense(cfg, params))
        self.torch.cuda.empty_cache()
        self._print("vlm", "vision_moves_bf16", self.vision_moves(cfg, params))
        self._print("vlm", "decode_bf16", self.decode(cfg, params))
        del params
        self._print("vlm", "serve_bf16", self.serve(cfg))
        cut = dataclasses.replace(cfg, n_layers=VLM_LAYERS, dtype="float32")
        self._print("vlm", "recurrence_f32",
                    self.prefill_vs_decode(cut, VLM_RECURRENCE, 4))

    def whisper(self) -> None:
        import dataclasses

        from repro_torch.configs import get_config

        cfg = get_config(WHISPER_ARCH)
        params = self._params(cfg)
        self._print("encdec", "encoder_bf16", self.encoder_ms(cfg, params))
        self._print("encdec", "prefill_bf16",
                    self.timed_prefill(cfg, params, VLM_PREFILL, 3, 3))
        self.torch.cuda.empty_cache()
        self._print("encdec", "cross_chunked_vs_dense_f32",
                    self.cross_chunked_vs_dense(cfg, params))
        self._print("encdec", "decode_bf16", self.decode(cfg, params))
        del params
        self._print("encdec", "serve_bf16", self.serve(cfg))
        cut = dataclasses.replace(cfg, n_layers=WHISPER_LAYERS,
                                  enc_layers=WHISPER_LAYERS, dtype="float32")
        self._print("encdec", "recurrence_f32",
                    self.prefill_vs_decode(cut, VLM_RECURRENCE, 4))

    def run(self) -> dict:
        t0 = time.perf_counter()
        for model in (self.llama, self.whisper):
            model()
            self.torch.cuda.empty_cache()
        self.summary["seconds"] = time.perf_counter() - t0
        print(f"phase vlm: {self.summary['seconds']:.1f} s", flush=True)
        return self.summary


# ---- phase train ----------------------------------------------------------

# Training through the port's entry points (``launch.steps.make_train_step``,
# ``launch.train.train`` and its CLI).  The cell: Mamba-2-780m at full width
# and depth in bf16 with ``remat="full"`` and float32 moments, on
# ``train_4k``'s 4096-token sequences with its global batch of 256 cut to 8
# for time and memory, in 2 microbatches of 4 (the forward of one matches
# phase lm's checked prefill shape).  One warm-up step (step 0, whose
# learning rate is 0), then 3 timed.
TRAIN_ARCH = LM_ARCH
TRAIN_SEQ = 4096
TRAIN_BATCH = 8
TRAIN_MICRO = 2
TRAIN_TIMED = 3
# D's launches a step: 48 layers x 2 (the remat recompute) x 2 microbatches;
# its backward's: 48 layers x 2 microbatches
TRAIN_D_LAUNCHES = 48 * 2 * TRAIN_MICRO
TRAIN_D_BWD_LAUNCHES = 48 * TRAIN_MICRO
# launches of D's backward profiled for its parts' device times
TRAIN_BWD_PROFILED = 5
# D's autograd Function on layer 0's SSD inputs of an f32 forward at full
# width (2 x 4096); the f32 card-vs-CPU steps and the restart run 4 of the
# 48 layers at full width on 2 x 512 tokens (cut for time: the CPU runs the
# same two steps)
TRAIN_D_TOKENS = (2, 4096)
TRAIN_CUT_LAYERS = 4
TRAIN_CUT_TOKENS = (2, 512)
TRAIN_RESTART_STEPS = 6
TRAIN_CKPT_EVERY = 3
# Hymba-1.5B at full width, 4 of its 32 layers (cut for time): layers 0 and
# 3 global, 1 and 2 sliding (the window of 1024 bites at 4096 tokens)
TRAIN_HY_LAYERS = 4
TRAIN_HY_GLOBAL = (0, 3)
TRAIN_HY_TOKENS = (2, 4096)
TRAIN_CLI = ("--arch", "deepseek_7b", "--steps", "3")
# step 0's loss against the cross-entropy of forward's whole logits in f32
TRAIN_LOSS_RTOL = 1e-3
# f32 card against CPU: losses, and step 1's gradients per leaf against
# that leaf's max |grad| (the same f32 operations in another order, the
# embedding's backward summed by atomics on the card)
TRAIN_CPU_RTOL = 1e-4
# the replayed last loss after a restart: the reference's own rtol
# (tests/test_integration.py); CUDA's embedding backward sums with atomics,
# so bitwise replay is not promised
TRAIN_REPLAY_RTOL = 1e-4


class TrainPhase(Lm):
    """Phase train: the port's training path on the card.  Every check
    prints one ``train {...}`` line; a failed check raises."""

    TAG = "train"
    ARCH = TRAIN_ARCH

    # ---- instruments --------------------------------------------------

    def _spans(self):
        """Patch the step's parts with CUDA events: D's forward calls
        (``ssm.ssd_scan``), the Function's backward calls
        (``ops.ssd_scan_bwd_kernel``), ``chunked_ce`` (its forward, and its
        backward from the loss's gradient to the hidden states') and the
        optimizer update.  Returns ``(spans, restore)``; ``spans`` maps a
        part to its list of event pairs."""
        from repro_torch.kernels.ssd_scan import ops
        from repro_torch.models import model as M
        from repro_torch.models import ssm
        from repro_torch.optim import adamw

        torch = self.torch
        spans = {k: [] for k in ("ssd_fwd", "ssd_bwd", "ce_fwd", "ce_bwd",
                                 "update")}

        def ev():
            return torch.cuda.Event(enable_timing=True)

        def timed(part, fn):
            def wrapper(*a, **k):
                e = (ev(), ev())
                e[0].record()
                out = fn(*a, **k)
                e[1].record()
                spans[part].append(e)
                return out
            return wrapper

        real = (ssm.ssd_scan, ops.ssd_scan_bwd_kernel, M.chunked_ce,
                adamw.AdamW.update)

        def ce(cfg, params, hidden, targets, **kw):
            out = timed("ce_fwd", real[2])(cfg, params, hidden, targets, **kw)
            if out.requires_grad:
                # the loss's gradient reaches ``out`` through an exact
                # product by 1, so the hook is not the root's
                e = (ev(), ev())
                out.register_hook(lambda g: e[0].record())
                hidden.register_hook(lambda g: e[1].record())
                spans["ce_bwd"].append(e)
                out = out * 1.0
            return out

        ssm.ssd_scan = timed("ssd_fwd", real[0])
        ops.ssd_scan_bwd_kernel = timed("ssd_bwd", real[1])
        M.chunked_ce = ce
        adamw.AdamW.update = timed("update", real[3])

        def restore():
            (ssm.ssd_scan, ops.ssd_scan_bwd_kernel, M.chunked_ce,
             adamw.AdamW.update) = real

        return spans, restore

    def _grads_of_updates(self):
        """Patch ``AdamW.update`` to keep the gradients each update is
        given.  Returns ``(kept, restore)``."""
        from repro_torch.optim import adamw

        kept = []
        real = adamw.AdamW.update

        def update(opt, grads, *a, **k):
            kept.append(grads)
            return real(opt, grads, *a, **k)

        adamw.AdamW.update = update

        def restore():
            adamw.AdamW.update = real

        return kept, restore

    def _batch(self, cfg, shape, step):
        from repro_torch.data.pipeline import DataConfig, batch_at

        data = DataConfig(vocab=cfg.vocab, seq_len=shape[1],
                          global_batch=shape[0])
        return {"tokens": self.torch.from_numpy(
            batch_at(data, step)["tokens"]).to(self.device)}

    def _cut(self, dtype="float32"):
        import dataclasses

        return dataclasses.replace(self.cfg, n_layers=TRAIN_CUT_LAYERS,
                                   dtype=dtype)

    # ---- checks -------------------------------------------------------

    def d_autograd(self) -> dict:
        """Check 1: layer 0's SSD inputs of an f32 forward at full width,
        through the Function (kernel D forward, its backward kernel) under
        random upstream gradients for ``y`` and the state: one counted
        launch of each; ``y`` and the state within ``plain_tol`` of
        ``ssd_scan_plain``; every input's gradient present, finite, within
        ``plain_tol`` of ``ssd_scan_bwd_plain`` on the same inputs (float32
        sums in another order) and, against float64 autograd through
        ``ssd_scan_plain``, within ``kd.f64_tol`` of plain float32
        autograd's own error; a second run of the backward kernel equal bit
        for bit."""
        from repro_torch.kernels import build
        from repro_torch.kernels.ssd_scan import ops
        from repro_torch.kernels.ssd_scan import ssd_scan as kd
        from repro_torch.models import model as M
        from repro_torch.models import ssm

        torch = self.torch
        cfg = self._cut()
        params = M.init_params(cfg, 0, device=self.device)
        seen = []
        real = ssm.ssd_scan

        def capture(*a, chunk):
            if not seen:
                seen.append(([t.detach().clone() for t in a], chunk))
            return real(*a, chunk=chunk)

        ssm.ssd_scan = capture
        try:
            with torch.no_grad():
                M.hidden_forward(cfg, params, self._tokens(TRAIN_D_TOKENS, 11))
        finally:
            ssm.ssd_scan = real
        del params
        args, chunk = seen[0]
        gen = torch.Generator(device=self.device).manual_seed(12)
        b, S, H, P = args[0].shape
        gy = torch.randn((b, S, H, P), generator=gen, device=self.device)
        gs = torch.randn((b, H, P, args[3].shape[-1]), generator=gen,
                         device=self.device)
        names = ("x", "dt", "A", "B", "C", "D")
        fn_in = [t.clone().requires_grad_() for t in args]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        build.reset_launch_counts()
        ev[0].record()
        y, state = ops.ssd_scan(*fn_in, chunk=chunk)
        ev[1].record()
        got = torch.autograd.grad((y, state), fn_in, (gy, gs))
        ev[2].record()
        counts = self._counts()
        if counts != self._expect(1, bwd=1):
            raise AssertionError(f"train d_autograd: launch counts {counts}")
        if y.grad_fn is None:
            raise AssertionError("train d_autograd: y has no autograd history")
        again = kd.ssd_scan_bwd_kernel(*args, gy, gs, chunk=chunk)
        with torch.no_grad():
            py, ps = kd.ssd_scan_plain(*args, chunk=chunk)
            pb = kd.ssd_scan_bwd_plain(*kd.prepare(*args, chunk=chunk), gy, gs,
                                       chunk=chunk)
        own = ops.ssd_scan_vjp(args, chunk, [True] * 6, gy, gs)
        want = ops.ssd_scan_vjp([t.double() for t in args], chunk, [True] * 6,
                                gy.double(), gs.double())
        torch.cuda.synchronize()
        y, state = y.detach(), state.detach()
        ey = float((y - py).abs().max())
        es = float((state - ps).abs().max())
        ty, ts = kd.plain_tol(py, torch.float32), kd.plain_tol(ps, torch.float32)
        if not (ey <= ty and es <= ts):
            raise AssertionError(f"train d_autograd: y err {ey} (tol {ty}),"
                                 f" state err {es} (tol {ts})")
        grads = {}
        for n, g, a, p, o, w in zip(names, got, again, pb, own, want):
            if g is None or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"train d_autograd: d{n} missing or"
                                     " not finite")
            scale = float(w.abs().max())
            grads[n] = dict(
                max_abs=float(g.abs().max()),
                err_plain=float((g - p).abs().max()),
                tol_plain=kd.plain_tol(p, torch.float32),
                err_f64=float((g.double() - w).abs().max()),
                autograd_f32_err_f64=float((o.double() - w).abs().max()),
                equal_bits=bool(torch.equal(g, a)))
            grads[n]["limit_f64"] = kd.f64_tol(
                grads[n]["autograd_f32_err_f64"], scale)
        bad = {n: r for n, r in grads.items()
               if not (r["err_plain"] <= r["tol_plain"]
                       and r["err_f64"] <= r["limit_f64"] and r["equal_bits"])}
        if bad:
            raise AssertionError(f"train d_autograd: gradients out of bounds"
                                 f" or not reproducible: {bad}")
        row = dict(cell=f"D autograd f32 {b}x{S} (layer 0)",
                   launches=counts[kd.SSD_SCAN.symbol],
                   bwd_launches=counts[kd.SSD_SCAN_BWD.symbol],
                   y_max_abs_err=ey, state_max_abs_err=es, y_tol=ty,
                   state_tol=ts, grads=grads,
                   fwd_ms=ev[0].elapsed_time(ev[1]),
                   bwd_ms=ev[1].elapsed_time(ev[2]))
        self._print(row)
        self.summary["d_autograd"] = row
        return row

    def full_step(self) -> dict:
        """Check 2, the cell: Mamba-2-780m at full width and depth, bf16,
        remat full, through ``make_train_step(cfg, microbatches=2)``.  One
        warm-up step and ``TRAIN_TIMED`` timed, each with D's launches
        counted (``TRAIN_D_LAUNCHES``) and the peak memory since just
        before it; step 0's loss against the cross-entropy of ``forward``'s
        whole logits in f32; the params after step 0 equal those before
        (its learning rate is 0) and after step 1 not; the parts' device
        time by CUDA events.  Layer 0's SSD inputs of the first forward
        are kept for the two kernels' entries."""
        import torch.nn.functional as F

        from repro_torch.kernels import build
        from repro_torch.kernels.ssd_scan import ssd_scan as kd
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import model as M
        from repro_torch.models import ssm
        from repro_torch.models.params import leaves

        torch, cfg = self.torch, self.cfg
        shape = (TRAIN_BATCH, TRAIN_SEQ)
        params = M.init_params(cfg, 0, device=self.device)
        step_fn, opt = make_train_step(cfg, microbatches=TRAIN_MICRO)
        state = opt.init(params)
        captured = []
        real = ssm.ssd_scan

        def capture(*a, chunk):
            if not captured:
                captured.append((kd.prepare(*(t.detach() for t in a),
                                            chunk=chunk), chunk))
            return real(*a, chunk=chunk)

        steps = []
        for i in range(1 + TRAIN_TIMED):
            batch = self._batch(cfg, shape, i)
            spans, restore = self._spans() if i else ({}, lambda: None)
            if not i:
                ssm.ssd_scan = capture
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                new, state, loss = step_fn(params, state, batch)
                torch.cuda.synchronize()
            finally:
                restore()
                ssm.ssd_scan = real
            ms = (time.perf_counter() - t0) * 1e3
            counts = self._counts()
            if counts != self._expect(TRAIN_D_LAUNCHES,
                                      bwd=TRAIN_D_BWD_LAUNCHES):
                raise AssertionError(f"train step {i}: launch counts {counts};"
                                     f" want {TRAIN_D_LAUNCHES} of D and"
                                     f" {TRAIN_D_BWD_LAUNCHES} of its"
                                     " backward")
            loss = float(loss)
            if not math.isfinite(loss):
                raise AssertionError(f"train step {i}: loss {loss}")
            moved = sum(int((a != b).sum()) for a, b in zip(leaves(new),
                                                            leaves(params)))
            if (moved > 0) != (i > 0):
                raise AssertionError(f"train step {i}: {moved} param values"
                                     " moved (step 0's learning rate is 0)")
            row = dict(step=i, loss=loss, ms=ms,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       moved=moved, launches=counts[kd.SSD_SCAN.symbol],
                       bwd_launches=counts[kd.SSD_SCAN_BWD.symbol])
            for part, evs in spans.items():
                row[f"{part}_ms"] = sum(a.elapsed_time(b) for a, b in evs)
                row[f"{part}_calls"] = len(evs)
            if not i:
                with torch.no_grad():
                    toks = batch["tokens"]
                    logits, _ = M.forward(cfg, params, toks[:, :-1])
                    ce = float(F.cross_entropy(
                        logits.float().reshape(-1, cfg.vocab),
                        toks[:, 1:].reshape(-1).long()))
                    del logits
                row["forward_ce"] = ce
                if abs(loss - ce) > TRAIN_LOSS_RTOL * abs(ce):
                    raise AssertionError(f"train step 0: loss {loss} against"
                                         f" the forward's cross-entropy {ce}")
            params = new
            steps.append(row)
            self._print(dict(cell=f"train step bf16 {shape[0]}x{shape[1]}",
                             **row))
        timed = steps[1:]
        ms = statistics.median(r["ms"] for r in timed)
        parts = {p: statistics.median(r[f"{p}_ms"] for r in timed)
                 for p in ("ssd_fwd", "ssd_bwd", "ce_fwd", "ce_bwd",
                           "update")}
        n_params = sum(t.numel() for t in leaves(params))
        row = dict(cell=(f"train_4k bf16 {shape[0]}x{shape[1]}, remat full,"
                         f" {TRAIN_MICRO} microbatches"),
                   n_params=n_params, step_ms=ms,
                   step_ms_runs=[r["ms"] for r in timed],
                   tokens_per_s=shape[0] * shape[1] / ms * 1e3,
                   peak_gb=max(r["peak_gb"] for r in timed),
                   launches=TRAIN_D_LAUNCHES,
                   bwd_launches=TRAIN_D_BWD_LAUNCHES,
                   losses=[r["loss"] for r in steps],
                   step0_loss_vs_forward_ce=abs(steps[0]["loss"]
                                                - steps[0]["forward_ce"]),
                   **{f"{p}_ms": v for p, v in parts.items()},
                   **{f"{p}_share": v / ms for p, v in parts.items()})
        self._print(row)
        self.summary["step_bf16"] = row
        del params, new, state
        self.torch.cuda.empty_cache()
        self.kernel_at_train_shape(*captured[0])
        self.bwd_at_train_shape(*captured[0])
        return row

    def kernel_at_train_shape(self, args, chunk) -> None:
        """D at the step's shapes (one microbatch's layer-0 inputs): the
        kernel against ``ssd_scan_plain`` (``plain_tol``), the
        ``TRAIN_D_LAUNCHES`` launches of a step as one bare span behind a
        device spin (median), the same calls of the plain version as one
        span, and the bound of those launches."""
        from repro_torch.kernels.ssd_scan import ssd_scan as kd

        torch = self.torch
        y, state = kd.ssd_scan_kernel(*args, chunk=chunk)
        py, ps = kd.ssd_scan_plain(*args, chunk=chunk)
        ey = float((y.float() - py.float()).abs().max())
        es = float((state - ps).abs().max())
        ty, ts = kd.plain_tol(py.float(), py.dtype), kd.plain_tol(ps, torch.float32)
        if not (ey <= ty and es <= ts):
            raise AssertionError(f"train D at the step's shapes: y err {ey}"
                                 f" (tol {ty}), state err {es} (tol {ts})")
        stream = torch.cuda.current_stream().cuda_stream

        def bare():
            for _ in range(TRAIN_D_LAUNCHES):
                kd.launch(*args, y, state, chunk, stream=stream)

        ms = _median_ms(bare, torch)
        kd.ssd_scan_plain(*args, chunk=chunk)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(TRAIN_D_LAUNCHES):
            kd.ssd_scan_plain(*args, chunk=chunk)
        b.record()
        b.synchronize()
        layers = [dict(args=args, chunk=chunk, state=state)] * TRAIN_D_LAUNCHES
        row = dict(cell=f"D at the step's shapes {tuple(args[0].shape)}"
                   f" {args[0].dtype}", launches=TRAIN_D_LAUNCHES,
                   y_max_abs_err=ey, state_max_abs_err=es, ms=ms,
                   plain_ms=a.elapsed_time(b), **self.bound(layers))
        self._print(row)
        self.summary["d_train_shape"] = row

    def bwd_at_train_shape(self, args, chunk) -> None:
        """D's backward at the step's shapes (one microbatch's layer-0
        inputs, bf16, a random bf16 gradient of ``y`` and none of the
        state, as in the step): each gradient against
        ``ssd_scan_bwd_plain``'s within ``plain_tol`` at its type; a
        second launch equal bit for bit; the step's
        ``TRAIN_D_BWD_LAUNCHES`` launches as one bare span behind a device
        spin and as wrapper calls (medians), the same calls of the plain
        version as one span, and the bound of those launches."""
        from repro_torch.kernels.ssd_scan import ssd_scan as kd

        torch = self.torch
        x = args[0]
        b, S, H, P = x.shape
        N = args[3].shape[-1]
        gen = torch.Generator(device=self.device).manual_seed(13)
        gy = torch.randn(x.shape, generator=gen, device=self.device).to(x.dtype)
        gs = torch.zeros((b, H, P, N), dtype=torch.float32, device=self.device)
        got = kd.ssd_scan_bwd_kernel(*args, gy, None, chunk=chunk)
        again = kd.ssd_scan_bwd_kernel(*args, gy, None, chunk=chunk)
        want = kd.ssd_scan_bwd_plain(*args, gy, gs, chunk=chunk)
        names = ("x", "dt", "A", "B", "C", "D")
        errs, tols = {}, {}
        for n, g, w in zip(names, got, want):
            errs[n] = float((g.float() - w.float()).abs().max())
            tols[n] = kd.plain_tol(w.float(), g.dtype)
        equal = all(bool(torch.equal(g, a)) for g, a in zip(got, again))
        if not equal or any(errs[n] > tols[n] for n in names):
            raise AssertionError(f"train D backward at the step's shapes:"
                                 f" errors {errs} (tolerances {tols}),"
                                 f" equal bits {equal}")
        stream = torch.cuda.current_stream().cuda_stream
        gx = [torch.empty_like(t) for t in args]

        def bare():
            for _ in range(TRAIN_D_BWD_LAUNCHES):
                kd.launch_bwd(*args, gy, gs, *gx, chunk, stream=stream)

        ms = _median_ms(bare, torch)
        parts = self._bwd_parts(
            lambda: kd.launch_bwd(*args, gy, gs, *gx, chunk, stream=stream))
        call_ms = _median_ms(
            lambda: [kd.ssd_scan_bwd_kernel(*args, gy, None, chunk=chunk)
                     for _ in range(TRAIN_D_BWD_LAUNCHES)], torch, spin=False)
        kd.ssd_scan_bwd_plain(*args, gy, gs, chunk=chunk)
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(TRAIN_D_BWD_LAUNCHES):
            kd.ssd_scan_bwd_plain(*args, gy, gs, chunk=chunk)
        e.record()
        e.synchronize()
        row = dict(cell=f"D backward at the step's shapes {tuple(x.shape)}"
                   f" {x.dtype}", launches=TRAIN_D_BWD_LAUNCHES,
                   grad_max_abs_err=errs, grad_tol=tols, equal_bits=equal,
                   max_abs_err=max(errs.values()), ms=ms, call_ms=call_ms,
                   plain_ms=a.elapsed_time(e), parts_ms_a_launch=parts,
                   **self.bwd_bound(args, chunk, TRAIN_D_BWD_LAUNCHES))
        self._print(row)
        self.summary["d_bwd_train_shape"] = row

    def _bwd_parts(self, launch) -> dict:
        """Device ms a launch of each of the backward's kernels, by
        ``torch.profiler`` over ``TRAIN_BWD_PROFILED`` calls of
        ``launch``; empty where the profiler records no device time."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        launch()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRAIN_BWD_PROFILED):
                launch()
            torch.cuda.synchronize()
        parts = {}
        for ev in prof.key_averages():
            t = (getattr(ev, "device_time_total", 0)
                 or getattr(ev, "cuda_time_total", 0))
            name = re.search(r"bwd_\w+", ev.key)
            if t and name:
                parts[name.group(0)] = t / TRAIN_BWD_PROFILED / 1e3
        return parts

    def bwd_bound(self, args, chunk, calls) -> dict:
        """The least time of ``calls`` backward launches on ``args``.  Per
        chunk and sequence, over the Q(Q+1)/2 pairs k <= q: the scores
        ``C B^T`` once (2 N a pair), their head-summed gradient against B
        and C (4 N), and per head ``dy x^T`` and ``G^T dy`` (2 P each),
        then per head five state products of 2 Q P N (the chunk's own
        state and adjoint, ``dh B``, the state terms of dC and dB; the
        carried state's term of the decay's gradient,
        ``dy[q] . (exp(cums[q]) h_in C[q])``, is ``exp(cums[q]) C[q]``
        dotted with dC's per-head state term ``h_in^T dy[q]``, Q N a head),
        each once, at the peak rate of x's type;
        against x, gy, dx, B, C, dB, dC, dt, ddt, A, dA, D, dD read or
        written once at the HBM rate.  ``ops_ms_f32`` prices the same
        FLOPs at the float32 rate the kernel's FMAs run at."""
        x, dt, A, B, C, D = args
        b, S, H, P = x.shape
        N, Q = B.shape[-1], chunk
        tri = Q * (Q + 1) // 2
        flops = calls * 2 * b * (S // Q) * (
            3 * tri * N + H * (2 * tri * P + 5 * Q * P * N))
        nbytes = calls * (3 * x.numel() * x.element_size()
                          + 4 * B.numel() * B.element_size()
                          + 2 * (dt.numel() + A.numel() + D.numel()) * 4)
        dtype = str(x.dtype).removeprefix("torch.")
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
        return dict(bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
                    ops_ms=ops_ms,
                    ops_ms_f32=flops / PEAK_FLOPS["float32"] * 1e3,
                    gflop_per_call=flops / calls / 1e9,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")

    def card_vs_cpu(self) -> dict:
        """Check 3: Mamba-2-780m at full width and ``TRAIN_CUT_LAYERS``
        layers, f32, two ``make_train_step`` steps from the same params on
        the same batches, on the card (kernel D) and on the CPU (its plain
        version): the losses within ``TRAIN_CPU_RTOL`` relative, step 1's
        gradients per leaf within ``TRAIN_CPU_RTOL`` of the leaf's max
        |grad| (the worst leaf printed), D's launches a step counted."""
        from repro_torch.checkpoint.checkpointer import leaf_paths
        from repro_torch.kernels import build
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import model as M
        from repro_torch.models.params import tree_map

        torch = self.torch
        cfg = self._cut()
        params = M.init_params(cfg, 0, device=self.device)
        cpu = torch.device("cpu")
        runs = []
        for dev, p in ((self.device, params),
                       (cpu, tree_map(lambda t: t.to(cpu), params))):
            step_fn, opt = make_train_step(cfg)
            state = opt.init(p)
            kept, restore = self._grads_of_updates()
            losses, ms = [], []
            try:
                for i in range(2):
                    batch = {k: v.to(dev) for k, v in
                             self._batch(cfg, TRAIN_CUT_TOKENS, i).items()}
                    build.reset_launch_counts()
                    t0 = time.perf_counter()
                    p, state, loss = step_fn(p, state, batch)
                    losses.append(float(loss))
                    ms.append((time.perf_counter() - t0) * 1e3)
                    on_card = dev == self.device
                    want = self._expect(2 * cfg.n_layers if on_card else 0,
                                        bwd=cfg.n_layers if on_card else 0)
                    if self._counts() != want:
                        raise AssertionError(f"train card vs CPU ({dev}):"
                                             f" launch counts {self._counts()}")
            finally:
                restore()
            runs.append(dict(losses=losses, ms=ms,
                             grads=tree_map(lambda t: t.to(cpu), kept[1])))
        card, host = runs
        for a, b in zip(card["losses"], host["losses"]):
            if not abs(a - b) <= TRAIN_CPU_RTOL * abs(b):
                raise AssertionError(f"train card vs CPU: losses {card['losses']}"
                                     f" against {host['losses']}")
        worst = (0.0, "")
        for (path, g), (_, h) in zip(leaf_paths(card["grads"]),
                                     leaf_paths(host["grads"])):
            mag = float(h.abs().max())
            ratio = float((g - h).abs().max()) / mag if mag else float(
                g.abs().max())
            worst = max(worst, (ratio, path))
        if not worst[0] <= TRAIN_CPU_RTOL:
            raise AssertionError(f"train card vs CPU: step 1's gradient of"
                                 f" {worst[1]} off by {worst[0]} of its max")
        row = dict(cell=(f"f32 {TRAIN_CUT_LAYERS} layers {TRAIN_CUT_TOKENS[0]}x"
                         f"{TRAIN_CUT_TOKENS[1]}, card vs CPU, 2 steps"),
                   card_losses=card["losses"], cpu_losses=host["losses"],
                   card_ms=card["ms"], cpu_ms=host["ms"],
                   worst_grad_leaf=worst[1], worst_grad_rel_err=worst[0],
                   launches_per_step=2 * cfg.n_layers,
                   bwd_launches_per_step=cfg.n_layers)
        self._print(row)
        self.summary["card_vs_cpu_f32"] = row
        return row

    def restart(self) -> dict:
        """Check 4: ``train`` in-process on the card at check 3's cut, 6
        steps with a checkpoint at step 3, then resumed from it: the
        replayed last loss within ``TRAIN_REPLAY_RTOL``."""
        from repro_torch.launch.train import train

        cfg = self._cut()
        kw = dict(reduced=False, steps=TRAIN_RESTART_STEPS,
                  seq_len=TRAIN_CUT_TOKENS[1], global_batch=TRAIN_CUT_TOKENS[0],
                  log_every=100, device=self.device)
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            first = train(cfg, ckpt_dir=d, ckpt_every=TRAIN_CKPT_EVERY, **kw)
            first_s = time.perf_counter() - t0
            resumed = train(cfg, ckpt_dir=d, ckpt_every=100, resume=True, **kw)
        if not (len(first) == TRAIN_RESTART_STEPS
                and len(resumed) == TRAIN_RESTART_STEPS - TRAIN_CKPT_EVERY - 1
                and all(math.isfinite(v) for v in first + resumed)):
            raise AssertionError(f"train restart: losses {first}, {resumed}")
        err = abs(resumed[-1] - first[-1])
        if not err <= TRAIN_REPLAY_RTOL * abs(first[-1]):
            raise AssertionError(f"train restart: replayed last loss"
                                 f" {resumed[-1]} against {first[-1]}")
        row = dict(cell=(f"train() f32 {TRAIN_CUT_LAYERS} layers, "
                         f"{TRAIN_RESTART_STEPS} steps, checkpoint at step "
                         f"{TRAIN_CKPT_EVERY}, resumed"),
                   losses=first, resumed=resumed, replay_abs_err=err,
                   first_run_s=first_s)
        self._print(row)
        self.summary["restart_f32"] = row
        return row

    def hymba(self) -> dict:
        """Check 5: Hymba-1.5B at full width and ``TRAIN_HY_LAYERS``
        layers (global ``TRAIN_HY_GLOBAL``, the rest sliding), bf16, two
        train steps of 2 x 4096 through the repaired chunked attention:
        losses finite, every leaf's gradient finite and not all zero, D's
        launches a step counted (a layer's forward and its recompute), and
        its backward's (one a layer, at Hymba's state of 16)."""
        import dataclasses

        from repro_torch.checkpoint.checkpointer import leaf_paths
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import model as M

        torch = self.torch
        cfg = dataclasses.replace(get_config(HY_ARCH), n_layers=TRAIN_HY_LAYERS,
                                  global_layers=TRAIN_HY_GLOBAL)
        params = M.init_params(cfg, 0, device=self.device)
        step_fn, opt = make_train_step(cfg)
        state = opt.init(params)
        kept, restore = self._grads_of_updates()
        losses, ms = [], []
        try:
            for i in range(2):
                batch = self._batch(cfg, TRAIN_HY_TOKENS, i)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                build.reset_launch_counts()
                t0 = time.perf_counter()
                params, state, loss = step_fn(params, state, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss))
                if self._counts() != self._expect(2 * cfg.n_layers,
                                                  bwd=cfg.n_layers):
                    raise AssertionError(f"train hymba step {i}: launch counts"
                                         f" {self._counts()}")
        finally:
            restore()
        bad = [p for grads in kept for p, g in leaf_paths(grads)
               if not bool(torch.isfinite(g).all()) or not bool(g.any())]
        if bad or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"train hymba: losses {losses}; gradients"
                                 f" not finite or all zero: {bad}")
        row = dict(cell=(f"hymba bf16 {TRAIN_HY_LAYERS} layers (global"
                         f" {list(TRAIN_HY_GLOBAL)}) {TRAIN_HY_TOKENS[0]}x"
                         f"{TRAIN_HY_TOKENS[1]}, 2 steps"),
                   losses=losses, step_ms=ms,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   leaves=len(leaf_paths(kept[0])),
                   launches_per_step=2 * cfg.n_layers,
                   bwd_launches_per_step=cfg.n_layers)
        self._print(row)
        self.summary["hymba_bf16"] = row
        return row

    def cli(self) -> dict:
        """Check 6: ``python -m repro_torch.launch.train`` with
        ``TRAIN_CLI`` (the reduced config, on the card) as a subprocess:
        exit 0, a loss line for steps 0 and 2, finite, and the summary
        line."""
        self.torch.cuda.empty_cache()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            print(f"train cli| {line}", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"train cli exited {proc.returncode}:"
                                 f" {proc.stderr[-4000:]}")
        losses = [float(line.split()[-1]) for line in proc.stdout.splitlines()
                  if line.startswith("step ")]
        if (len(losses) != 2 or not all(math.isfinite(v) for v in losses)
                or not proc.stdout.splitlines()[-1].startswith("first loss")):
            raise AssertionError(f"train cli: output {proc.stdout[-2000:]}")
        row = dict(cell="train cli " + " ".join(TRAIN_CLI), losses=losses,
                   seconds=time.perf_counter() - t0)
        self._print(row)
        self.summary["cli"] = row
        return row

    def run(self) -> tuple[dict, dict]:
        """The six checks; returns kernel D's and its backward's training
        entries of the kernels line."""
        from repro_torch.kernels.ssd_scan import ssd_scan as kd

        t0 = time.perf_counter()
        d = self.d_autograd()
        self.torch.cuda.empty_cache()
        step = self.full_step()
        for check in (self.card_vs_cpu, self.restart, self.hymba, self.cli):
            self.torch.cuda.empty_cache()
            check()
        self.summary["seconds"] = time.perf_counter() - t0
        print(f"phase train: {self.summary['seconds']:.1f} s", flush=True)
        k = self.summary["d_train_shape"]
        kb = self.summary["d_bwd_train_shape"]
        fwd = dict(
            name=f"{kd.SSD_SCAN.symbol}@{self.ARCH}_train",
            path=f"{self.ARCH} train step", route="cuda",
            source=kd.SSD_SCAN.source, replaces=kd.SSD_SCAN.replaces,
            launches=step["launches"],
            max_abs_err=max(k["y_max_abs_err"], k["state_max_abs_err"],
                            d["y_max_abs_err"], d["state_max_abs_err"]),
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], ops_ms_f32=k["ops_ms_f32"],
            fwd_call_ms=step["ssd_fwd_ms"],
            # no single PyTorch call computes the SSD chunk scan
            library_ms=None,
        )
        bwd = dict(
            name=f"{kd.SSD_SCAN_BWD.symbol}@{self.ARCH}_train",
            path=f"{self.ARCH} train step", route="cuda",
            source=kd.SSD_SCAN_BWD.source, replaces=kd.SSD_SCAN_BWD.replaces,
            launches=step["bwd_launches"],
            max_abs_err=kb["max_abs_err"], ms=kb["ms"],
            call_ms=kb["call_ms"], plain_ms=kb["plain_ms"],
            bound_ms=kb["bound_ms"], bound_by=kb["bound_by"],
            ops_ms_f32=kb["ops_ms_f32"], step_call_ms=step["ssd_bwd_ms"],
            parts_ms_a_launch=kb["parts_ms_a_launch"],
            # no single PyTorch call computes the SSD scan's gradient
            library_ms=None,
        )
        return fwd, bwd


# ---- phase plan -----------------------------------------------------------

# the dry run on the single production mesh (256 H100s as (data, model) =
# (32, 8)): one architecture a family, each of its steps, and the
# long_500k cells, the four of the quadratic families recorded as skipped.
# Cut for the phase's 90 s (the card host's 8 cores trace about 750 s of
# CPU for the one-a-family set): the VLM family's train_4k and prefill_32k,
# the hybrid, MoE and audio families' train_4k (82, 80, about 80, 34 and
# 55 s of CPU); the full matrix on both meshes runs through the CLI
# (python -m repro_torch.launch.dryrun --mesh both --workers 8, 264 s).
PLAN_ARCHS = {"ssm": "mamba2_780m", "hybrid": "hymba_1_5b",
              "dense": "deepseek_7b", "moe": "qwen2_moe_a2_7b",
              "vlm": "llama32_vision_11b", "audio": "whisper_large_v3"}
PLAN_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
PLAN_CUT = (("llama32_vision_11b", "train_4k"),
            ("llama32_vision_11b", "prefill_32k"),
            ("hymba_1_5b", "train_4k"), ("qwen2_moe_a2_7b", "train_4k"),
            ("whisper_large_v3", "train_4k"))
PLAN_SKIPPED = ("arctic_480b", "minicpm3_4b", "glm4_9b", "phi4_mini_3_8b")
PLAN_BUDGET_S = 90.0
# the dry run of the FLOP check: a bf16 Mamba-2 prefill of 4 x 4096
PLAN_FLOP_TOKENS = (4, 4096)


class PlanPhase:
    """Phase plan: the port's dry run, roofline and gradient compression.

    (a) the dry run of one cell per (family, step) on the single
    production mesh (less :data:`PLAN_CUT`), traced in worker processes
    (one a CPU core), every supported cell ``ok``; (b) the dry run on a
    1 x 1 mesh of the shapes the earlier phases ran on the card, its
    predicted bytes and roofline bound beside their measured peak memory
    and time (the predicted total times ``dryrun.HBM_MARGIN`` at least the
    peak), and ``FlopCounterMode`` around a real bf16 Mamba-2 prefill
    against the dry run's FLOPs for it (equal); (c) ``compressed_mean``
    over NCCL at world size 1 against ``_dequantize(_quantize(g))``.
    Every check prints one ``plan {...}`` line; a failed check raises."""

    def __init__(self, torch, device, *, lm, hybrid, moe, train):
        self.torch, self.device = torch, device
        self.measured = {
            "mamba2_780m": (lm["prefill_32k_bf16"], "forward_ms"),
            "hymba_1_5b": (hybrid["prefill_32k_bf16"], "forward_ms"),
            "qwen2_moe_a2_7b": (moe["moe"]["qwen_prefill_32k"],
                                "forward_ms"),
            "mamba2_780m_train": (train["step_bf16"], "step_ms"),
        }
        self.summary = {}

    def _print(self, key, row) -> None:
        print("plan " + json.dumps(row), flush=True)
        self.summary[key] = row

    def compressed_mean(self) -> None:
        """(c): the int8 all-reduce mean over a real NCCL group of one."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.optim.grad_compress import (
            _dequantize,
            _quantize,
            compressed_mean,
        )

        torch = self.torch
        mesh = make_host_mesh()
        try:
            gen = torch.Generator(device=self.device).manual_seed(23)
            g = torch.randn((4097, 33), generator=gen, device=self.device,
                            dtype=torch.float32)
            got = compressed_mean(g)
            q, scale = _quantize(g)
            want = _dequantize(q, scale, g.shape)
            torch.cuda.synchronize()
            equal = bool(torch.equal(got, want))
            row = dict(check="compressed_mean nccl world 1",
                       backend=dist.get_backend(), world=dist.get_world_size(),
                       mesh=list(mesh.shape), numel=g.numel(), equal=equal)
        finally:
            dist.destroy_process_group()
        self._print("compressed_mean", row)
        if not equal:
            raise AssertionError("compressed_mean at world size 1 is not"
                                 " _dequantize(_quantize(g))")

    def flop_count(self) -> int:
        """``FlopCounterMode`` around a real bf16 Mamba-2 prefill of
        :data:`PLAN_FLOP_TOKENS` on the card."""
        from torch.utils.flop_counter import FlopCounterMode

        from repro_torch.configs import get_config
        from repro_torch.launch.steps import make_prefill_step
        from repro_torch.models import model as M

        torch = self.torch
        cfg = get_config("mamba2_780m")
        params = M.init_params(cfg, 0, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(4)
        tokens = torch.randint(0, cfg.vocab, PLAN_FLOP_TOKENS, generator=gen,
                               device=self.device)
        prefill = make_prefill_step(cfg)
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            out = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError("flop-counted prefill: logits not finite")
        del params, out
        torch.cuda.empty_cache()
        return int(fc.get_total_flops()), ms

    def run(self) -> dict:
        from repro_torch.configs.shapes import ShapeConfig
        from repro_torch.launch import dryrun, roofline
        from repro_torch.launch import mesh as MESH

        torch = self.torch
        t0 = time.perf_counter()
        workers = max(1, os.cpu_count() or 1)
        pool = dryrun._pool(workers)  # the workers boot during (c)
        try:
            self.compressed_mean()
            card_flops, flop_ms = self.flop_count()
        except BaseException:
            pool.terminate()
            raise
        total_mem = torch.cuda.get_device_properties(0).total_memory
        self._print("card", dict(total_memory=total_mem,
                                 hbm_per_chip=roofline.HBM_PER_CHIP,
                                 workers=workers))
        # (a) the production mesh and (b) a 1 x 1 mesh at the shapes the
        # earlier phases ran, their traces submitted together
        cells_a = [(PLAN_ARCHS[f], s) for s in PLAN_SHAPES
                   for f in PLAN_ARCHS if (PLAN_ARCHS[f], s) not in PLAN_CUT]
        cells_a += [(a, "long_500k") for a in PLAN_SKIPPED]
        cells_b = [
            ("mamba2_780m", "prefill_32k",
             ShapeConfig("prefill_32k", *LM_TIMED[::-1], "prefill"),
             {"full_depth": True}),
            ("hymba_1_5b", "prefill_32k",
             ShapeConfig("prefill_32k", *HY_TIMED[::-1], "prefill")),
            ("qwen2_moe_a2_7b", "prefill_32k",
             ShapeConfig("prefill_32k", *MOE_TIMED[::-1], "prefill")),
            ("mamba2_780m", "train_4k",
             ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train"),
             {"microbatches": TRAIN_MICRO}),
            ("mamba2_780m", "prefill_32k",
             ShapeConfig("prefill_32k", *PLAN_FLOP_TOKENS[::-1],
                         "prefill"), {"full_depth": True}),
        ]
        name = MESH.mesh_name()
        spec_a, spec_b = (MESH.SINGLE[1], MESH.SINGLE[2]), ((1, 1),
                                                             ("data", "model"))
        try:
            started_a = dryrun.start_cells(cells_a, spec_a, pool)
            started_b = dryrun.start_cells(cells_b, spec_b, pool)
            recs_a = dryrun.finish_cells(started_a, MESH.fake_mesh(*spec_a),
                                         name)
            ta = time.perf_counter() - t0
            recs = dryrun.finish_cells(started_b, MESH.fake_mesh(*spec_b),
                                       "host_1x1")
            tb = time.perf_counter() - t0
        finally:
            pool.terminate()
            pool.join()
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
        for rec in recs_a:
            row = dict(cell=f"{rec['arch']} {rec['shape']}", mesh=name,
                       status=rec["status"])
            if rec["status"] == "ok":
                r = roofline.analyze_record(rec)
                row.update(
                    gb_a_device=rec["memory"]["total_bytes"] / 1e9,
                    fits=rec["fits_hbm"],
                    flops_a_device=rec["hlo"]["flops_per_device"],
                    collective_gb=(rec["hlo"]["collective_bytes_per_device"]
                                   / 1e9),
                    dominant=r.dominant, roofline_frac=r.roofline_frac,
                    compute_s=r.compute_s, memory_s=r.memory_s,
                    collective_s=r.collective_s,
                    microbatches=rec["microbatches"],
                    probes=rec["probes"], nodes=rec["nodes"],
                    trace_cpu_s=rec["t_trace_s"])
            else:
                row["reason"] = rec.get("reason") or rec.get("error")
            self._print(f"a {rec['arch']} {rec['shape']}", row)
        self._print("cut", dict(cells_cut=[" ".join(c) for c in PLAN_CUT],
                                why="the phase's 90 s; the CLI runs them"))
        bad = [r for r in recs_a if r["status"] == "error"]
        if bad:
            raise AssertionError(f"dry run: {len(bad)} cells failed:"
                                 f" {[(r['arch'], r['shape']) for r in bad]}"
                                 f" {bad[0]['error']}")
        for rec in recs:
            if rec["status"] != "ok":
                raise AssertionError(f"dry run 1x1 {rec['arch']}"
                                     f" {rec['shape']}: {rec.get('error')}")
        flop_rec = recs.pop()
        dry_flops = flop_rec["hlo"]["flops_per_device"]
        row = dict(check="FlopCounterMode vs the 1x1 dry run",
                   cell=f"mamba2_780m prefill bf16 {PLAN_FLOP_TOKENS[0]}x"
                        f"{PLAN_FLOP_TOKENS[1]}",
                   card_flops=card_flops, dry_run_flops=dry_flops,
                   equal=card_flops == dry_flops, counted_prefill_ms=flop_ms)
        self._print("flops", row)
        if card_flops != dry_flops:
            raise AssertionError(f"FlopCounterMode counted {card_flops}, the"
                                 f" dry run {dry_flops}")
        uncovered = []
        for rec in recs:
            key = rec["arch"] + ("_train" if rec["step"] == "train" else "")
            measured, ms_key = self.measured[key]
            r = roofline.analyze_record(rec)
            mem = rec["memory"]
            # fits_hbm's margin must cover the peak the card measured
            covered = (mem["total_bytes"] * rec["hbm_margin"] / 1e9
                       >= measured["peak_gb"])
            if not covered:
                uncovered.append(key)
            self._print(f"b {key}", dict(
                cell=(f"{rec['arch']} {rec['step']} bf16 "
                      f"{rec['global_batch']}x{rec['seq_len']}"),
                mesh="1x1", depth=rec["depth"],
                predicted_argument_gb=mem["argument_bytes"] / 1e9,
                predicted_total_gb=mem["total_bytes"] / 1e9,
                measured_peak_gb=measured["peak_gb"],
                measured_over_predicted=(measured["peak_gb"] * 1e9
                                         / mem["total_bytes"]),
                hbm_margin=rec["hbm_margin"], margin_covers=covered,
                bound_ms=r.bound() * 1e3, bound_by=r.dominant,
                compute_ms=r.compute_s * 1e3, memory_ms=r.memory_s * 1e3,
                measured_ms=measured[ms_key],
                flops=rec["hlo"]["flops_per_device"],
                trace_cpu_s=rec["t_trace_s"]))
        if uncovered:
            raise AssertionError(f"dry run 1x1: the measured peak of"
                                 f" {uncovered} is over the predicted total"
                                 " times dryrun.HBM_MARGIN")
        seconds = time.perf_counter() - t0
        self._print("time", dict(
            phase="plan", seconds=seconds, dry_run_a_s=ta, dry_run_b_s=tb,
            workers=workers, total_memory=total_mem,
            hbm_per_chip=roofline.HBM_PER_CHIP,
            total_memory_equal=total_mem == roofline.HBM_PER_CHIP))
        print(f"phase plan: {seconds:.1f} s", flush=True)
        if seconds > PLAN_BUDGET_S:
            raise AssertionError(f"phase plan took {seconds:.1f} s, over its"
                                 f" {PLAN_BUDGET_S:.0f} s")
        return self.summary


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
        with tracing(launches=True) as col:
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
                        run["graph"], pyr, budget=dataclasses.replace(
                            plan.budget, nbytes=e.detail["budget"]),
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

        plan, batch = run["plan"], run["batch"]
        sizes = sorted({plan.budget.working_set(p.launch, batch)
                        for p in plan.pyramids}, reverse=True)
        for hi, lo in zip(sizes, sizes[1:] + [0]):
            budget = dataclasses.replace(plan.budget, nbytes=(hi + lo) // 2)
            try:
                splits = [len(replan_pyramid(
                    run["graph"], p, budget=budget, batch=batch,
                    compute_dtype=run["dtype"]))
                    for p in plan.pyramids
                    if not budget.fits(p.launch, batch)]
            except BudgetError:
                continue
            if max(splits) >= 2:
                return budget.nbytes / plan.budget.nbytes
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
            with tracing(launches=True):
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
            "untraced_ms": run["summary"]["eager_forward_ms"],
            "replayed_ms": run["summary"]["forward_ms"],
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
             "resnet18", "--run", "--guard", "--trace", str(path),
             "--budget", "reference"],
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


# ---- phase serve ----------------------------------------------------------

# ResNet-18 at full width (224x224x3, 1000 classes) on phase 3's master
# params, served through buckets (1, 2, 4, 8); nothing cut
SERVE_RUN = "resnet18/float32/b1"
SERVE_BUCKETS = (1, 2, 4, 8)
# a wave: 24 requests of 1, 2, 3, 1, 2, 3, ... images, drained after 1, 1,
# 1 and 4 requests in turn, so that the batches fill every bucket
SERVE_REQUESTS = 24
SERVE_SIZES = (1, 2, 3)
SERVE_GROUPS = (1, 1, 1, 4)
SERVE_REPS = 5
# the overload run: injected slow launches make a batch wall ~60 ms, far
# above the card's few ms, so the deadlines rest on what the engine models
SERVE_DELAY_S = 0.06
SERVE_BURST = 20


class Serve:
    """The serving engine and its front end (``repro_torch.net.serve``,
    ``repro_torch.net.frontend``) on ResNet-18 at 224 x 224, every fused
    batch through the compiled forward: kernels A and B replayed from
    captured CUDA graphs."""

    def __init__(self, smoke):
        self.torch = smoke.torch
        self.device = smoke.device
        run = next(r for r in smoke.runs if r["key"] == SERVE_RUN)
        self.graph, self.master = run["graph"], run["params"]
        self.summary = {}
        self.launches = {}

    def engine(self, **cfg):
        from repro_torch.core.program import REFERENCE_BUDGET
        from repro_torch.net.serve import ServeConfig, ServingEngine

        return ServingEngine(self.graph, self.master,
                             ServeConfig(buckets=SERVE_BUCKETS,
                                         budget=REFERENCE_BUDGET, **cfg),
                             device=self.device)

    def images(self, rows, seed):
        import numpy as np

        g = self.graph
        return np.random.default_rng(seed).standard_normal(
            (rows, g.input_size, g.input_size, g.in_channels)
        ).astype(np.float32)

    def stream(self, seed):
        return [self.images(SERVE_SIZES[i % len(SERVE_SIZES)], seed + i)
                for i in range(SERVE_REQUESTS)]

    def check(self, results, xs, what, *, dtype="float32") -> float:
        """Every request completed, its logits against the port's
        reference_network on its own rows (f32: ``_tol``; bf16:
        ``bf16_logit_tol``); returns the largest error."""
        from repro_torch.net.runner import bf16_logit_tol, reference_network

        torch, worst = self.torch, 0.0
        for res, x in zip(results, xs):
            if not res.ok:
                raise AssertionError(f"serve {what}: request {res.id}"
                                     f" failed: {res.error!r}")
            ref = reference_network(torch.from_numpy(x).to(self.device),
                                    self.graph, self.master).cpu()
            got = torch.from_numpy(res.logits)
            if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"serve {what}: logits {got.shape}")
            err = float((got - ref).abs().max())
            tol = (_tol(ref, "float32") if dtype == "float32"
                   else bf16_logit_tol(ref))
            if not err <= tol:
                raise AssertionError(f"serve {what}: request {res.id} max"
                                     f" abs err {err} > tol {tol}")
            worst = max(worst, err)
        return worst

    @staticmethod
    def plan_counts(plan):
        from repro_torch.kernels import build
        from repro_torch.kernels.fused_conv import fused_conv as fc

        want = {k.symbol: 0 for k in build.KERNELS}
        for pyr in plan.pyramids:
            want[(fc.PYRAMID_KTILED if pyr.launch.c_tiles > 1
                  else fc.PYRAMID).symbol] += 1
        return want

    def counted(self, eng, fn, what):
        """Run ``fn`` with the launch counts reset just before and read
        just after; they must equal the served plans' launches: each fused
        batch its bucket plan's, the eager and reference routes none."""
        from repro_torch.kernels import build

        self.torch.cuda.synchronize()
        build.reset_launch_counts()
        before = dict(eng.route_batches)
        out = fn()
        self.torch.cuda.synchronize()
        counts = {k.symbol: k.launches for k in build.KERNELS}
        want = {k.symbol: 0 for k in build.KERNELS}
        for (bucket, route), n in eng.route_batches.items():
            n -= before.get((bucket, route), 0)
            if route == "fused" and n:
                for k, v in self.plan_counts(eng._entry(bucket).plan).items():
                    want[k] += n * v
        if counts != want:
            raise AssertionError(f"serve {what}: launch counts {counts} !="
                                 f" the served plans' {want}")
        self.launches[what] = counts
        return out

    # -- the two waves ------------------------------------------------------

    def waves(self) -> dict:
        from repro_torch.net import runner
        from repro_torch.net.partition import partition_cache_info

        eng = self.engine()
        stream = self.stream(7)
        rows = {}

        def run():
            results, i, g = [], 0, 0
            while i < len(stream):
                n = SERVE_GROUPS[g % len(SERVE_GROUPS)]
                results += eng.serve(stream[i:i + n])
                i, g = i + n, g + 1
            return results

        for wave in (1, 2):
            traces = runner.jit_trace_count()
            misses = eng.cache_counters["misses"]
            part = partition_cache_info().misses
            t0 = time.perf_counter()
            results = self.counted(eng, run, f"wave {wave}")
            wall_s = time.perf_counter() - t0
            row = dict(
                requests=len(results), images=sum(r.rows for r in results),
                buckets=sorted({r.bucket for r in results}),
                captures=runner.jit_trace_count() - traces,
                plan_misses=eng.cache_counters["misses"] - misses,
                partition_misses=partition_cache_info().misses - part,
                logits_max_abs_err=self.check(results, stream,
                                              f"wave {wave}"),
                wall_s=wall_s, launches=self.launches[f"wave {wave}"],
            )
            rows[f"wave{wave}"] = row
            print(f"serve wave {wave} " + json.dumps(row), flush=True)
        if rows["wave1"]["buckets"] != list(SERVE_BUCKETS):
            raise AssertionError(f"serve: buckets {rows['wave1']['buckets']}")
        if rows["wave1"]["captures"] != len(SERVE_BUCKETS):
            raise AssertionError("serve: wave 1 did not capture once a"
                                 f" bucket: {rows['wave1']}")
        w2 = rows["wave2"]
        if (w2["captures"], w2["plan_misses"], w2["partition_misses"]) != (
                0, 0, 0):
            raise AssertionError(f"serve: wave 2 recompiled: {w2}")
        rows["summary"] = eng.summary()
        self.engine_f32 = eng
        return rows

    # -- each bucket: the replay against the eager forward, staging ---------

    def buckets(self) -> dict:
        """Per bucket: the replayed forward against the eager forward at
        the same key, bit for bit; ``b - 1`` real rows padded to the bucket
        against the same rows unpadded under the same plan (``_tol``, skip
        maps equal); the replay, the eager forward and the staging copy
        alone timed (median of 5 after a warm-up, host clock ending in a
        synchronize); the waves' latency and throughput beside them."""
        import numpy as np

        from repro_torch.net import runner
        from repro_torch.net.runner import run_network
        from repro_torch.net.serve import pad_to_bucket
        from repro_torch.obs.stats import timed_stats_ms

        torch, eng = self.torch, self.engine_f32
        waves = {r["bucket"]: r for r in
                 self.summary["waves"]["summary"]["buckets"]}
        out = {}
        for b in SERVE_BUCKETS:
            entry = eng._entry(b)
            host = self.images(b, 100 + b)
            x = torch.from_numpy(host).to(self.device)

            def replay(x=x, entry=entry):
                return run_network(x, entry.prepared, plan=entry.plan)

            def eager(x=x, entry=entry):
                return _eager_forward(x, entry.prepared, entry.plan,
                                      "float32")

            traces = runner.jit_trace_count()
            y, skips = replay()
            if runner.jit_trace_count() != traces:
                raise AssertionError(f"serve bucket {b}: the forward"
                                     " captured; the waves' graph missed")
            ye, skips_e = eager()
            torch.cuda.synchronize()
            if not (torch.equal(y, ye) and all(
                    torch.equal(skips[k], skips_e[k]) for k in skips_e)):
                raise AssertionError(f"serve bucket {b}: the replay differs"
                                     " from the eager forward")
            pad_err = None
            if b > 1:
                real = b - 1
                padded = torch.from_numpy(pad_to_bucket(host[:real], b))
                yp, sp = eager(padded.to(self.device))
                yu, su = eager(x[:real])
                pad_err = float((yp[:real] - yu).abs().max())
                if not pad_err <= _tol(yu, "float32") or not all(
                        torch.equal(sp[k][:real], su[k]) for k in su):
                    raise AssertionError(f"serve bucket {b}: padded rows"
                                         f" differ (err {pad_err})")

            def stage(host=host):
                _, ready, _ = eng._to_device(host)
                ready.synchronize()

            replay_ms = timed_stats_ms(replay, reps=SERVE_REPS)["p50_ms"]
            if runner.jit_trace_count() != traces:
                raise AssertionError(f"serve bucket {b}: a timed forward"
                                     " captured instead of replaying")
            row = dict(
                replay_ms=replay_ms,
                eager_ms=timed_stats_ms(eager, reps=SERVE_REPS)["p50_ms"],
                staging_ms=timed_stats_ms(stage, reps=SERVE_REPS)["p50_ms"],
                padded_rows_max_abs_err=pad_err,
                p50_ms=waves[b]["p50_ms"], p95_ms=waves[b]["p95_ms"],
                imgs_per_s=waves[b]["imgs_per_s"],
                batches=waves[b]["batches"],
                slo_us_model=waves[b]["slo_us"],
                launches=entry.plan.n_launches(),
            )
            out[str(b)] = row
            print(f"serve bucket {b} " + json.dumps(row), flush=True)
        return out

    # -- bf16, deadlines, faults, the front end, the CLI --------------------

    def bf16(self) -> dict:
        eng = self.engine(compute_dtype="bfloat16")
        xs = [self.images(1, 200 + i) for i in range(8)]
        results = self.counted(eng, lambda: eng.serve(xs), "bf16")
        if {r.bucket for r in results} != {8}:
            raise AssertionError("serve bf16: not one bucket-8 batch")
        return dict(logits_max_abs_err=self.check(results, xs, "bf16",
                                                  dtype="bfloat16"),
                    launches=self.launches["bf16"])

    @staticmethod
    def _slow():
        from repro_torch.robust.faults import FaultInjector

        inj = FaultInjector(seed=0)
        inj.slow_launch(SERVE_DELAY_S, times=10_000)
        return inj

    def deadlines(self) -> dict:
        """Warm a deadline-aware engine (clean, then slow launches, so its
        calibration maps the model's SLOs to this card's walls); then a
        burst of single images with a deadline of 5.2 slow batches: some
        are shed typed at admission, and every admitted one completes by
        its deadline or ends typed."""
        from repro_torch.robust.errors import DeadlineExceeded
        from repro_torch.robust.faults import inject

        eng = self.engine(deadline_aware=True, shed_margin=1.6)
        for b in SERVE_BUCKETS:
            eng.serve([self.images(b, 300 + b)])
        with inject(injector=self._slow()):
            for rep in range(2):
                for b in SERVE_BUCKETS:
                    eng.serve([self.images(b, 310 + 10 * rep + b)])
        deadline_us = 5.2 * SERVE_DELAY_S * 1e6
        xs = [self.images(1, 400 + i) for i in range(SERVE_BURST)]

        def burst():
            with inject(injector=self._slow()):
                ids = [eng.submit(x, deadline_us=deadline_us) for x in xs]
                eng.drain()
            return [eng.results[i] for i in ids]

        results = self.counted(eng, burst, "deadlines")
        done = [(r, x) for r, x in zip(results, xs) if r.ok]
        typed = [r for r in results if not r.ok
                 and isinstance(r.error, DeadlineExceeded)]
        shed = [r for r in typed if "eta_us" in r.error.context]
        late = [r for r, _ in done if r.latency_ms * 1e3 > deadline_us]
        if len(done) + len(typed) != len(results) or not shed or late:
            raise AssertionError(
                f"serve deadlines: {len(done)} done ({len(late)} late),"
                f" {len(typed)} typed ({len(shed)} shed) of {len(results)}")
        self.check([r for r, _ in done], [x for _, x in done], "deadlines")
        return dict(completed=len(done), shed=len(shed),
                    expired=len(typed) - len(shed),
                    deadline_ms=deadline_us / 1e3,
                    max_latency_ms=max(r.latency_ms for r, _ in done),
                    launches=self.launches["deadlines"])

    def inject_modes(self) -> dict:
        """Each of the CLI's ``INJECT_MODES`` through an engine with breaker
        1 and watchdog 3 (and the output sentinel for ``poison``), as the
        CLI arms them: a clean wave, then the same wave with the fault
        armed; every request ends in a result or a typed error, and the
        launches follow the routes the batches took."""
        from repro_torch.net.serve import INJECT_MODES, _armed_injector
        from repro_torch.robust.errors import RobustError
        from repro_torch.robust.faults import inject

        out = {}
        xs = [self.images(1 + i % 4, 500 + i) for i in range(8)]
        for mode in INJECT_MODES:
            eng = self.engine(breaker_threshold=1, breaker_cooldown_s=0.0,
                              watchdog_factor=3.0,
                              output_sentinel=mode == "poison")
            self.check(eng.serve(xs), xs, f"inject {mode} wave 1")

            def wave2(eng=eng, mode=mode):
                with inject(injector=_armed_injector(mode, 0, 1)) as inj:
                    return eng.serve(xs), inj

            results, inj = self.counted(eng, wave2, f"inject {mode}")
            if any(not r.ok and not isinstance(r.error, RobustError)
                   for r in results):
                raise AssertionError(f"serve inject {mode}: untyped end")
            ok = [(r, x) for r, x in zip(results, xs) if r.ok]
            self.check([r for r, _ in ok], [x for _, x in ok],
                       f"inject {mode}")
            res = eng.summary()["resilience"]
            cycled = [s for s in res["breakers"].values()
                      if s["opens"] >= 1 and s["state"] == "closed"]
            held = {
                "slow_launch": res["watchdog_trips"] >= 1 and bool(cycled),
                "stage_fail": res["failed"] >= 1
                and len(ok) == len(xs) - res["failed"],
                "poison": res["sentinel_trips"] >= 1 and len(ok) == len(xs),
                "stall": res["stalls"] == 3 and len(ok) == len(xs),
            }[mode]
            if not held or not inj.fired:
                raise AssertionError(f"serve inject {mode}: {res}")
            out[mode] = dict(
                completed=len(ok), failed=len(xs) - len(ok),
                fired=len(inj.fired),
                routes={f"{b}/{r}": n for (b, r), n in
                        sorted(eng.route_batches.items())},
                resilience={k: v for k, v in res.items() if k != "breakers"},
                breakers=res["breakers"],
                launches=self.launches[f"inject {mode}"],
            )
            print(f"serve inject {mode} " + json.dumps(out[mode]), flush=True)
        return out

    def frontend(self) -> dict:
        """4 producer threads x 8 requests through ``ServingFrontend``:
        every handle resolves exactly once, with its own rows' logits."""
        import threading

        from repro_torch.net.frontend import ServingFrontend

        eng = self.engine()
        got, lock, errors = {}, threading.Lock(), []

        def producer(tid, fe):
            try:
                for i in range(8):
                    x = self.images(1 + (tid + i) % 2, 600 + 10 * tid + i)
                    r = fe.submit(x).result(timeout=300.0)
                    with lock:
                        got.setdefault(r.id, []).append((r, x))
            except Exception as e:  # surfaced below
                errors.append(e)

        def hammer():
            with ServingFrontend(eng) as fe:
                threads = [threading.Thread(target=producer, args=(t, fe))
                           for t in range(4)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300.0)
                if any(t.is_alive() for t in threads):
                    raise AssertionError("serve frontend: a producer hangs")

        t0 = time.perf_counter()
        self.counted(eng, hammer, "frontend")
        wall_s = time.perf_counter() - t0
        if errors or len(got) != 32 or any(len(v) != 1 for v in got.values()):
            raise AssertionError(f"serve frontend: {len(got)} results,"
                                 f" errors {errors}")
        pairs = [v[0] for v in got.values()]
        err = self.check([r for r, _ in pairs], [x for _, x in pairs],
                         "frontend")
        return dict(resolved=len(got), logits_max_abs_err=err,
                    wall_s=wall_s, launches=self.launches["frontend"])

    def cli(self) -> dict:
        """``python -m repro_torch.net.serve --model resnet18 --requests
        32`` twice as subprocesses on the card: the dry stream, and a slow
        launch with breaker 1 and watchdog 3; both exit 0 with wave 2
        recompiling nothing."""
        self.torch.cuda.empty_cache()  # the subprocesses share the card
        out = {}
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        for name, extra in (("dry_stream", ["--dry-stream"]),
                            ("slow_launch", ["--inject", "slow_launch",
                                             "--breaker", "1",
                                             "--watchdog", "3"])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.net.serve", "--model",
                 "resnet18", "--requests", "32", "--budget", "reference",
                 *extra],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=600,
            )
            for line in proc.stdout.splitlines():
                print(f"serve cli {name}| " + line, flush=True)
            if proc.returncode != 0:
                raise AssertionError(f"serve cli {name} exited"
                                     f" {proc.returncode}:"
                                     f" {proc.stderr[-4000:]}")
            if "wave 2: +0 plans, +0 jit traces" not in proc.stdout:
                raise AssertionError(f"serve cli {name}: wave 2 recompiled")
            if name == "slow_launch" and "watchdog_trips=1" not in proc.stdout:
                raise AssertionError("serve cli slow_launch: no watchdog trip")
            out[name] = dict(rc=proc.returncode, s=time.perf_counter() - t0)
        return out

    def run(self) -> dict:
        self.summary["waves"] = self.waves()
        self.summary["buckets"] = self.buckets()
        self.summary["bf16"] = self.bf16()
        self.summary["deadlines"] = self.deadlines()
        self.summary["inject"] = self.inject_modes()
        self.summary["frontend"] = self.frontend()
        self.summary["cli"] = self.cli()
        print("serve launches " + json.dumps(self.launches), flush=True)
        for k in ("bf16", "deadlines", "frontend", "cli"):
            print(f"serve {k} " + json.dumps(self.summary[k]), flush=True)
        return self.summary


# ---- phase examples -------------------------------------------------------

# (model, dtype, must the END cascade skip cells on the sparse input): the
# fused CNN example at the zoo's full size under the card's budget.  The
# smallest-region plans of LeNet-5 and VGG-16 hold launches of two or more
# convs over a tile grid finer than the image, where tiles die; AlexNet's
# (one tile an image) and ResNet-18's (one-conv launches) hold none
EXAMPLES_FUSED = (
    ("lenet", "float32", True),
    ("alexnet", "float32", False),
    ("vgg16", "float32", True),
    ("resnet18", "float32", False),
    ("resnet18", "bfloat16", False),
    ("vgg16", "bfloat16", True),
)
# cut from the example's 300 steps for the phase's time: 300 took 51.0 s
# and the phase 159.6 s (a run of the phase alone on an H100 80GB HBM3 at
# 700 W), over its 150 s
EXAMPLES_TRAIN_STEPS = 200
EXAMPLES_QUICKSTART_TOL = 1e-5
EXAMPLES_SERVE_TOKENS = 12
# fused-example lines echoed (the plan rows and traced spans stay in --out)
_EXAMPLE_ECHO = ("plan (", "run_network:", "max |err|", "kernel launches",
                 "forward:", "smallest-region plan", "sparse input",
                 "  END skips", "END skipped")


def _search(pattern: str, text: str, what: str):
    m = re.search(pattern, text, re.M)
    if m is None:
        raise AssertionError(f"examples {what}: no line matches {pattern!r}")
    return m


class ExamplesPhase:
    """The port's four examples (``examples/torch_*.py``) run as a user
    runs them: one subprocess each, ``PYTHONPATH=src``, on the card (no
    ``--device``), reusing the kernel libraries phase 1 built under
    ``build/``.  Each must exit 0; its printed lines are parsed and held to
    what the example claims (module docstring, phase 12)."""

    def __init__(self, torch):
        self.torch = torch
        self.env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        self.summary: dict = {}

    def _run(self, name: str, *args: str, echo=None) -> tuple[str, float]:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"),
             *args],
            cwd=ROOT, env=self.env, capture_output=True, text=True,
            timeout=600,
        )
        seconds = time.perf_counter() - t0
        tag = " ".join((name, *args))
        for line in proc.stdout.splitlines():
            if echo is None or line.startswith(echo):
                print(f"examples {tag}| {line}", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"examples {tag} exited {proc.returncode}:"
                                 f" {proc.stderr[-4000:]}")
        return proc.stdout, seconds

    def quickstart(self) -> dict:
        out, seconds = self._run("quickstart")
        alpha = int(_search(r"^uniform alpha: (\d+)", out, "quickstart")[1])
        us = float(_search(r"DS-1 fused duration: ([\d.]+) us", out,
                           "quickstart")[1])
        gops = _search(r"([\d.]+) GOPS \(paper", out, "quickstart")[1]
        err = float(_search(r"fused vs reference max err: (\S+) \(cuda\)",
                            out, "quickstart")[1])
        end = _search(r"END: ([\d.]+)% detected negative early, ([\d.]+)%",
                      out, "quickstart")
        row = dict(alpha=alpha, duration_us=us, gops=gops, max_abs_err=err,
                   end_detected_pct=float(end[1]),
                   end_cycles_saved_pct=float(end[2]), s=seconds)
        if (alpha, us, gops) != (5, 13.75, "86.10"):
            raise AssertionError(f"examples quickstart: {row}")
        if not err <= EXAMPLES_QUICKSTART_TOL:
            raise AssertionError(f"examples quickstart: fused error {err}")
        return row

    def fused(self, model: str, dtype: str, must_skip: bool) -> dict:
        from repro_torch.net.graph import MODELS

        out, seconds = self._run("fused_cnn_inference", "--model", model,
                                 "--dtype", dtype,
                                 echo=(model,) + _EXAMPLE_ECHO)
        what = f"fused {model} {dtype}"
        size = int(_search(r"input (\d+)x\d+", out, what)[1])
        err, tol = _search(r"reference: (\S+) \(limit (\S+), ", out, what
                           ).groups()
        serr, stol = _search(r"^sparse input: max \|err\| (\S+) \(limit"
                             r" (\S+)\)", out, what).groups()
        a, b, plan_n = map(int, _search(
            r"fused_pyramid=(\d+) fused_pyramid_ktiled=(\d+) \(plan: (\d+)",
            out, what).groups())
        fired, cells = map(int, _search(r"END skipped cells: (\d+) of (\d+)",
                                        out, what).groups())
        tight = _search(r"^smallest-region plan: \d+ launches: (.*)$", out,
                        what)[1]
        grids = [(int(q), int(al)) for q, al in re.findall(
            r"Q=(\d+) alpha=(\d+)", tight)]
        row = dict(
            model=model, dtype=dtype, input_size=size,
            max_abs_err=float(err), limit=float(tol),
            sparse_max_abs_err=float(serr), sparse_limit=float(stol),
            launches_a=a, launches_b=b, plan_launches=plan_n,
            forward_ms=float(_search(r"^forward: ([\d.]+) ms", out, what)[1]),
            first_forward_s=float(_search(r"^run_network: .* in ([\d.]+)s", out,
                                          what)[1]),
            must_skip=must_skip, skipped_cells=fired, skip_cells=cells,
            skip_lines=out.count("  END skips "),
            tiled_q2=any(q >= 2 and al >= 2 for q, al in grids),
            s=seconds,
        )
        if size != MODELS[model]().input_size:
            raise AssertionError(f"examples {what}: input {size}")
        if not (row["max_abs_err"] <= row["limit"]
                and row["sparse_max_abs_err"] <= row["sparse_limit"]):
            raise AssertionError(f"examples {what}: logits {row}")
        if a < 1 or a + b != plan_n:
            raise AssertionError(f"examples {what}: launches {row}")
        # the cells that must skip do, whatever their plan; that the plan
        # still holds a tiled launch of two or more convs is a cross-check
        if must_skip and not (fired > 0 and row["skip_lines"] > 0
                              and row["tiled_q2"]):
            raise AssertionError(f"examples {what}: no END skip {row}")
        print("examples fused " + json.dumps(row), flush=True)
        return row

    def serve_lm(self) -> dict:
        out, seconds = self._run("serve_lm")
        rows = re.findall(r"^(\S+)\s+generated (\d+) tokens/seq at ([\d.]+)"
                          r" tok/s \(reduced config, (.+)\)$", out, re.M)
        rates = {arch: float(r) for arch, n, r, _ in rows}
        if (len(rows) != 3 or any(int(n) != EXAMPLES_SERVE_TOKENS
                                  for _, n, _, _ in rows)
                or not all(r > 0 for r in rates.values())):
            raise AssertionError(f"examples serve_lm: {rows}")
        return dict(tokens_per_s=rates, device=rows[0][3], s=seconds)

    def train_lm(self) -> dict:
        with tempfile.TemporaryDirectory() as ckpt:
            out, seconds = self._run(
                "train_lm", "--steps", str(EXAMPLES_TRAIN_STEPS),
                "--ckpt-dir", ckpt)
        m = _search(r"^loss: ([\d.]+) -> ([\d.]+) over (\d+) steps", out,
                    "train_lm")
        row = dict(first_loss=float(m[1]), last_loss=float(m[2]),
                   steps=int(m[3]), resumed="resumed" in out, s=seconds)
        if (row["steps"] != EXAMPLES_TRAIN_STEPS or row["resumed"]
                or not row["last_loss"] < row["first_loss"]):
            raise AssertionError(f"examples train_lm: {row}")
        return row

    def run(self) -> dict:
        t0 = time.perf_counter()
        self.torch.cuda.empty_cache()  # the subprocesses share the card
        self.summary["quickstart"] = self.quickstart()
        self.summary["fused"] = [self.fused(*cell) for cell in EXAMPLES_FUSED]
        self.summary["serve_lm"] = self.serve_lm()
        self.summary["train_lm"] = self.train_lm()
        for k in ("quickstart", "serve_lm", "train_lm"):
            print(f"examples {k} " + json.dumps(self.summary[k]), flush=True)
        self.summary["seconds"] = time.perf_counter() - t0
        print(f"phase examples: {self.summary['seconds']:.1f} s", flush=True)
        return self.summary


def _eager_forward(x, params, plan, dtype):
    """The forward issued launch by launch from Python, with no CUDA graph:
    what a replay is held against, bit for bit."""
    from repro_torch.core.executor import full_fp32
    from repro_torch.net.runner import _forward

    with full_fp32():
        return _forward(x, params, plan=plan, end_skip=True, cdt=dtype)


def _bound_by(times) -> str:
    return "bytes" if times["bytes_ms"] >= times["ops_ms"] else "operations"


def _forward_ms(run, *, eager: bool = False) -> float:
    """Median host time of a whole forward after a warm-up, each ended by
    a synchronize (``timed_stats_ms``, the ops phase's timer too): the
    compiled forward (a replay of its captured CUDA graph), or with
    ``eager`` the forward issued launch by launch."""
    from repro_torch.net.runner import jit_trace_count, run_network
    from repro_torch.obs.stats import timed_stats_ms

    if eager:
        return timed_stats_ms(
            lambda: _eager_forward(run["x"], run["prepared"], run["plan"],
                                   run["dtype"]),
            reps=OPS_REPS,
        )["p50_ms"]
    traces = jit_trace_count()
    ms = timed_stats_ms(
        lambda: run_network(run["x"], run["prepared"], plan=run["plan"]),
        reps=OPS_REPS,
    )["p50_ms"]
    if jit_trace_count() != traces:
        raise AssertionError(f"{run['key']}: a timed forward captured"
                             " instead of replaying its graph")
    return ms


def print_build_report(reports, fc, device) -> None:
    """The pyramid kernels', the SOP kernel's and the SSD scan's and its
    backward's ptxas lines (entry, registers, stack and spills) from this
    run's build; each
    pyramid kernel's co-resident block count per dtype (the grid of its
    cooperative launch) and the SSD scan's blocks a SM per instance at the
    Mamba-2 and Hymba models' head width, state and chunk."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan as kd

    for lib in ("fused_pyramid", "online_sop", "ssd_scan", "ssd_scan_bwd"):
        for line in reports.get(lib, "").splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")):
                print(f"ptxas {lib}: {line.strip()}", flush=True)
    for k in fc.KERNELS:
        for name, code in fc._DTYPE_CODES.items():
            print(f"resident blocks {k.symbol} {name}:"
                  f" {k.resident_blocks(code, device)}", flush=True)
    for arch in (LM_ARCH, HY_ARCH):
        cfg = get_config(arch)
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
        card_counts = smoke.phase_card()
        sop = smoke.phase_sop()
        # phase 3's captured forwards give their memory back for lm's peak
        from repro_torch.net.runner import clear_compiled_cache

        clear_compiled_cache()
        torch.cuda.empty_cache()
        lm = Lm(torch, device)
        ssd = lm.run()
        torch.cuda.empty_cache()
        hybrid = Hybrid(torch, device)
        ssd_hybrid = hybrid.run()
        torch.cuda.empty_cache()
        moe = MoePhase(torch, device).run()
        torch.cuda.empty_cache()
        vlm = VlmPhase(torch, device).run()
        torch.cuda.empty_cache()
        train = TrainPhase(torch, device)
        ssd_train, ssd_bwd_train = train.run()
        torch.cuda.empty_cache()
        plan = PlanPhase(torch, device, lm=lm.summary, hybrid=hybrid.summary,
                         moe=moe, train=train.summary).run()
        with tempfile.TemporaryDirectory() as tmp:
            ops = Ops(smoke, Path(tmp) if args.out is None
                      else args.out.parent).run()
        serve = Serve(smoke).run()
        examples = ExamplesPhase(torch).run()
        kernels = []
        for k in fc.KERNELS:
            st = smoke.stats[k.symbol]
            kernels.append(dict(
                name=k.symbol, route="cuda", source=k.source,
                replaces=k.replaces,
                launches=counts[k.symbol] + card_counts[k.symbol],
                launches_per_forward={r["key"]: r["launches"][k.symbol]
                                      for r in smoke.runs + smoke.card_runs},
                max_abs_err=st["max_abs_err"], ms=st["ms"],
                call_ms=st["call_ms"],
                plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
                bound_by=_bound_by(st), library_ms=st["library_ms"],
                card=(None if "card" not in st else dict(
                    st["card"], bound_by=_bound_by(st["card"]),
                    pyramids=sum(r["run"].endswith("@card")
                                 for r in st["rows"]))),
            ))
        kernels.append(sop)
        kernels.append(ssd)
        kernels.append(ssd_hybrid)
        kernels.append(ssd_train)
        kernels.append(ssd_bwd_train)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(dict(
                card=_smi(), kernels=kernels,
                pyramids={s: v["rows"] for s, v in smoke.stats.items()},
                end_to_end=[r["summary"] for r in smoke.runs],
                card_budget=dict(
                    cells=[r["summary"] for r in smoke.card_runs],
                    sweep=smoke.sweep, seconds=smoke.card_s),
                sop=smoke.sop_rows,
                lm=lm.summary,
                hybrid=hybrid.summary,
                moe=moe,
                vlm=vlm,
                train=train.summary,
                plan=plan,
                ops=ops,
                serve=serve,
                examples=examples,
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
