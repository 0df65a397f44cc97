"""End-to-end fused CNN inference on the PyTorch port, on the card.

Builds a zoo model as a graph (`repro_torch.net.graph`), lets the
memory-aware auto-partitioner pick the pyramid cuts under the card's budget
(`repro_torch.net.partition`, ``CARD_BUDGET``), executes the whole network
through the hand-written CUDA pyramid kernels (`repro_torch.net.runner`)
and verifies the logits against the monolithic PyTorch reference.  Also
demonstrates the END tile-skip cascade firing on spatially sparse input.
The port of ``examples/fused_cnn_inference.py``.

Run:  PYTHONPATH=src python examples/torch_fused_cnn_inference.py --model alexnet
      PYTHONPATH=src python examples/torch_fused_cnn_inference.py \\
          --model resnet18 --dtype bfloat16
      PYTHONPATH=src python examples/torch_fused_cnn_inference.py \\
          --model lenet --device cpu

On the card the input is the zoo model's full size (32 for LeNet-5, 227 for
AlexNet, 224 for VGG-16 and ResNet-18).  With ``--device cpu`` (the kernels'
plain PyTorch versions) the big models default to the reference example's
reduced sizes; ``--input-size`` overrides either.  Without ``--device`` it
runs on the CUDA card and exits non-zero when there is none.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import resolve_device
from repro_torch.core.program import CARD_BUDGET
from repro_torch.kernels import build
from repro_torch.kernels.fused_conv.fused_conv import KERNELS
from repro_torch.net.graph import MODELS, infer_shapes
from repro_torch.net.partition import auto_partition, layerwise_partition
from repro_torch.net.runner import (
    bf16_logit_tol,
    init_network_params,
    prepare_network_params,
    reference_network,
    run_network,
    skip_fractions,
)
from repro_torch.obs import timed_stats_ms, tracing

# the reference example's reduced sizes, kept for the plain path on the CPU
# (ResNet-50, which the reference does not have, as ResNet-18)
CPU_SIZE = {"lenet": 32, "alexnet": 67, "vgg16": 32, "resnet18": 32,
            "resnet50": 32}
# float32 logits against the float32 reference: this share of max|logit|
F32_LOGIT_RTOL = 1e-4
TIMED_REPS = 5


def logit_limit(ref: torch.Tensor, dtype: str) -> float:
    """The error a forward's logits may show against ``ref``:
    ``bf16_logit_tol`` at bf16, ``1e-4 * max(1, max|logit|)`` at f32."""
    if dtype == "bfloat16":
        return bf16_logit_tol(ref)
    return F32_LOGIT_RTOL * max(1.0, float(ref.abs().max()))


def describe(label: str, plan) -> None:
    print(f"{label}: {plan.n_launches()} launches: "
          + ", ".join(f"{p.name} Q={p.q_convs} alpha={p.launch.program.alpha}"
                      for p in plan.pyramids))


def skip_cells(skips: dict[str, torch.Tensor]) -> tuple[int, int]:
    """(skipped, skippable): the END cascade's (image, cell, level >= 1)
    flags that fired, of all there are.  A one-conv launch has none."""
    fired = sum(int(s[..., 1:].sum()) for s in skips.values())
    return fired, sum(s[..., 1:].numel() for s in skips.values())


def make_plans(graph, batch: int, budget=CARD_BUDGET):
    """(auto, layer-by-layer, smallest-region) plans under ``budget``."""
    return (auto_partition(graph, batch=batch, budget=budget),
            layerwise_partition(graph, batch=batch, budget=budget),
            auto_partition(graph, batch=batch, budget=budget,
                           prefer_region="smallest"))


def make_inputs(graph, batch: int, device):
    """Seed-0 network params and a seed-1 input batch, on ``device``."""
    params = init_network_params(graph, seed=0, device=device)
    x = torch.randn(
        (batch, graph.input_size, graph.input_size, graph.in_channels),
        generator=torch.Generator().manual_seed(1),
    ).to(device)
    return params, x


def sparse_inputs(graph, params, x):
    """Most tiles die after level 0: a seed-2 blob in the top-left
    quarter of an all-zero input, and every conv bias lowered by 0.3."""
    blob = max(4, graph.input_size // 4)
    xs = torch.zeros_like(x)
    xs[:, :blob, :blob, :] = torch.randn(
        (x.shape[0], blob, blob, graph.in_channels),
        generator=torch.Generator().manual_seed(2),
    ).to(x.device) * 3
    sparse_params = {
        k: (w, b - 0.3) if graph.node(k).op == "conv" else (w, b)
        for k, (w, b) in params.items()
    }
    return sparse_params, xs


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--model", choices=sorted(MODELS), default="lenet")
    ap.add_argument("--input-size", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="compute dtype for activations/weights; "
                         "accumulation stays f32 either way (DESIGN.md #11)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu: the"
                         " kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = dev.type == "cuda"

    size = args.input_size or (None if card else CPU_SIZE[args.model])
    kwargs = {"num_classes": 10, "compute_dtype": args.dtype}
    if size is not None:
        kwargs["input_size"] = size
    graph = MODELS[args.model](**kwargs)
    size = graph.input_size
    shapes = infer_shapes(graph)
    where = torch.cuda.get_device_name(dev) if card else "cpu"
    print(f"{graph.name}: {len(graph.nodes)} nodes, input {size}x{size}, "
          f"logits {shapes[graph.output.name].channels}, "
          f"compute dtype {graph.compute_dtype}, device {where}")

    plan, layer, tight = make_plans(graph, args.batch)
    print(plan.summary())
    describe(f"plan ({CARD_BUDGET.label} budget)", plan)
    print(f"layer-by-layer baseline: {layer.hbm_bytes():,}B over "
          f"{layer.n_launches()} launches -> auto saves "
          f"{1 - plan.hbm_bytes() / layer.hbm_bytes():.1%} modeled HBM traffic")

    params, x = make_inputs(graph, args.batch, dev)
    prepared = prepare_network_params(plan, params)
    t0 = time.perf_counter()
    logits, _ = run_network(x, prepared, plan=plan)
    if card:
        torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    print(f"run_network: logits {tuple(logits.shape)} in {first_s:.2f}s "
          + ("(the first forward: kernel libraries built at first use, "
             "the forward run eagerly, then captured as a CUDA graph)"
             if card else "(the kernels' plain PyTorch versions)"))
    ref = reference_network(x, graph, params)
    err = float((logits.float() - ref).abs().max())
    tol = logit_limit(ref, args.dtype)
    print(f"max |err| vs monolithic f32 reference: {err}"
          f" (limit {tol:.6g}, {args.dtype})")
    assert err <= tol, f"{args.dtype} error {err} exceeds its limit {tol}"

    # later forwards replay the captured graph; count one and time some
    build.reset_launch_counts()
    again, _ = run_network(x, prepared, plan=plan)
    counts = {k.symbol: k.launches for k in KERNELS}
    print("kernel launches per forward: "
          + " ".join(f"{k}={n}" for k, n in counts.items())
          + f" (plan: {plan.n_launches()} launches)")
    assert torch.equal(again, logits), "a second forward changed the logits"
    if card:
        assert sum(counts.values()) == plan.n_launches(), counts
    ms = timed_stats_ms(lambda: run_network(x, prepared, plan=plan),
                        reps=TIMED_REPS)["p50_ms"]
    print(f"forward: {ms:.3f} ms (median of {TIMED_REPS}"
          + (f", CUDA-graph replay, {where})" if card else ", cpu)"))

    # sparse input: most tiles die after level 0, the END cascade skips the
    # deeper convs of each pyramid.  The smallest-region plan has the
    # paper's smallest-tile preference: maximal tile grids, so the per-tile
    # skips become visible.
    describe("smallest-region plan", tight)
    sparse_params, xs = sparse_inputs(graph, params, x)
    # run the sparse forward traced (DESIGN.md #12): one measured+modeled
    # span per fused launch, recorded launch by launch
    with tracing(launches=True) as collector:
        logits_s, skips_s = run_network(
            xs, prepare_network_params(tight, sparse_params), plan=tight
        )
    ref_s = reference_network(xs, graph, sparse_params)
    err_s = float((logits_s.float() - ref_s).abs().max())
    tol_s = logit_limit(ref_s, args.dtype)
    print(f"sparse input: max |err| {err_s} (limit {tol_s:.6g})")
    assert err_s <= tol_s, f"sparse error {err_s} exceeds its limit {tol_s}"
    for name, frac in skip_fractions(skips_s).items():
        if any(f > 0 for f in frac):
            print(f"  END skips {name}: "
                  + ", ".join(f"L{i}={f:.0%}" for i, f in enumerate(frac)))
    fired, cells = skip_cells(skips_s)
    print(f"END skipped cells: {fired} of {cells} (image, cell, level >= 1)")
    print("traced launches (modeled cycle-model time vs measured "
          + ("CUDA-event time):" if card else "host time):"))
    for s in collector.spans:
        print(f"  {s.name:<24} {s.regime:<16} modeled {s.modeled_us:>9,.1f}us"
              f"   measured {s.duration_ms:>9,.3f}ms")
    print(f"  (python -m repro_torch.obs.explain --model {args.model} "
          "--trace t.json renders the full plan table + Perfetto timeline)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
