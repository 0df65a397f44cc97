"""Quickstart on the PyTorch port: the USEFUSE core in five minutes.

Plans a fusion pyramid for LeNet-5 (Algorithms 3-4), runs the fused executor
against the monolithic reference, reproduces the paper's Table-1 duration via
Eq. (3), and shows END early-termination statistics on the first conv layer.
The port of ``examples/quickstart.py``, imported from ``repro_torch.core``
as that one imports from ``repro.core``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py               # the card
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain path

Without ``--device`` it runs on the CUDA card and exits non-zero when there
is none.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import (
    end_statistics,
    evaluate_design,
    fused_forward,
    init_pyramid_params,
    lockstep_plan,
    plan_fusion,
    reference_forward,
    resolve_device,
    to_digits,
)
from repro_torch.core.cnn_models import LENET5_FUSION, PAPER_OPS
from repro_torch.core.executor import conv_windows, full_fp32


def make_inputs(device) -> tuple[torch.Tensor, object]:
    """LeNet-5's seed-0 pyramid params and a seed-1 input (1, 32, 32, 1)."""
    params = init_pyramid_params(LENET5_FUSION, seed=0, device=device)
    x = torch.randn((1, 32, 32, 1), generator=torch.Generator().manual_seed(1))
    return x.to(device), params


def fused_error(x: torch.Tensor, params) -> float:
    """Max |fused - reference| of the lockstep executor at region 1."""
    ref = reference_forward(x, LENET5_FUSION, params)
    fused = fused_forward(x, LENET5_FUSION, params,
                          lockstep_plan(LENET5_FUSION, 1))
    return float((ref - fused).abs().max())


def window_values(x: torch.Tensor, params) -> torch.Tensor:
    """CL1's first filter over 256 of its windows.  ``conv_windows`` orders
    a window's features ``(C, K, K)`` and HWIO flattens ``(K, K, C)``; the
    two agree only because CL1 has one input channel."""
    win, _ = conv_windows(x, LENET5_FUSION, level=0, max_windows=256)
    with full_fp32():
        return win[0] @ params.weights[0].reshape(-1, 6)[:, 0]


def end_figures(vals: torch.Tensor):
    """END over 16 SD digits of the values scaled by four population
    standard deviations (``correction=0``, as ``jnp.std``)."""
    vn = torch.clamp(vals / (4 * torch.std(vals, correction=0)), -0.999, 0.999)
    return end_statistics(to_digits(vn, 16), vn)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu: the"
                         " plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. plan the fusion pyramid (Eq. (1) + Algorithms 3-4) -------------
    plan = plan_fusion(LENET5_FUSION, out_region=1)
    print("uniform alpha:", plan.alpha, " (paper: 5)")
    for lvl, ls in zip(LENET5_FUSION.levels, plan.levels):
        print(f"  {lvl.name}: tile {ls.tile}x{ls.tile}  stride S^T={ls.stride}")

    # --- 2. fused execution == monolithic reference --------------------------
    x, params = make_inputs(dev)
    print(f"fused vs reference max err: {fused_error(x, params)}"
          f" ({dev.type})")

    # --- 3. Eq. (3) cycle model reproduces Table 1 --------------------------
    res = evaluate_design("ds1", LENET5_FUSION, plan,
                          PAPER_OPS[("lenet", "Fused")])
    print(f"DS-1 fused duration: {res.duration_us} us (paper: 13.75 us), "
          f"{res.gops:.2f} GOPS (paper: 86.10) -- the paper's FPGA cycle"
          " model, not a time measured here")

    # --- 4. END early negative detection ------------------------------------
    st = end_figures(window_values(x, params))
    print(f"END: {100 * st.detected_frac:.1f}% detected negative early, "
          f"{100 * st.cycle_savings:.1f}% digit cycles saved")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
