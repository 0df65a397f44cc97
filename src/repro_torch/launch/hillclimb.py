"""Perf hill-climb harness: trace a cell under named sharding and config
variants, re-price the roofline terms on the H100, print a row a variant.

The port of the reference's ``repro.launch.hillclimb``: a variant's cell
is traced by :func:`repro_torch.launch.dryrun.fitted_cost`, recorded as
the dry run records it and priced by
:func:`repro_torch.launch.roofline.analyze_record`.  Variants are the
reference's named experiments:

  baseline       — the rules the dry-run table used
  fsdp           — drop tensor parallelism for weights; both mesh axes do
                   parameter sharding (data-parallel compute, FSDP gathers)
  sp             — sequence parallelism: the residual stream seq-sharded
                   over 'model' between layers
  fsdp_gbf16     — fsdp with bf16 gradients before the update
  fsdp_gbf16_dots — and remat that keeps the matmul outputs
  ep_fsdp, ep2d  — expert parallelism (MoE)

Usage: PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
           --arch glm4_9b --shape train_4k --mesh single \\
           --variants baseline,fsdp
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import mesh as MESH
from repro_torch.launch.dryrun import (
    argument_bytes,
    cell_record,
    fitted_cost,
    record_of,
)
from repro_torch.launch.roofline import analyze_record

_FSDP = {
    "batch": ("data", "model"),
    "heads": (), "kv_heads": (), "mlp": (), "experts": (), "lora": (),
    "embed": ("data", "model"),
    "vocab": (),
}

# each variant: sharding-rule overrides + optional trace knobs
VARIANTS: dict[str, dict] = {
    "baseline": {"rules": {}},
    # FSDP-dominant: DP over both mesh axes, weights sharded over both
    # axes, no tensor parallelism; one row a device, no microbatching
    "fsdp": {"rules": dict(_FSDP), "microbatches": 1},
    # sequence parallelism on the residual stream (keeps TP)
    "sp": {"rules": {"seq": ("model",)}},
    # fsdp + bf16 gradients before the data-parallel reduce
    "fsdp_gbf16": {"rules": dict(_FSDP), "microbatches": 1,
                   "grad_dtype": "bfloat16"},
    # fsdp + bf16 grads + dots-saveable remat (no recompute re-gathers)
    "fsdp_gbf16_dots": {"rules": dict(_FSDP), "microbatches": 1,
                        "grad_dtype": "bfloat16", "cfg": {"remat": "dots"}},
    # expert parallelism on 'model' + dense/attn weights FSDP + DP
    "ep_fsdp": {
        "rules": {"heads": (), "kv_heads": (), "mlp": (), "lora": (),
                  "embed": ("data",)},
    },
    # 2D expert parallelism: experts over (pod x model), expert-internal
    # dims over 'data' — tokens move (all-to-all), weights never whole
    "ep2d": {
        "rules": {"experts": ("pod", "model"), "heads": (), "kv_heads": (),
                  "lora": (), "mlp": ("data",), "embed": ("data",)},
    },
}


def run_variant(arch: str, shape_name: str, mesh_name: str, variant: str,
                mesh=None) -> dict:
    """One variant's roofline row on ``mesh`` (the production mesh named
    by ``mesh_name`` when ``None``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if mesh is None:
        mesh = MESH.make_production_mesh(multi_pod="multi" in mesh_name)
    v = VARIANTS[variant]
    if v.get("cfg"):
        cfg = dataclasses.replace(cfg, **v["cfg"])
    t0 = time.time()
    rules = v["rules"] or None
    cost, meta = fitted_cost(cfg, shape, mesh, rules_override=rules,
                             microbatches=v.get("microbatches"),
                             grad_dtype=v.get("grad_dtype"))
    arg = argument_bytes(cfg, shape, mesh, rules_override=rules,
                         microbatches=meta["microbatches"])
    rec = cell_record(arch, shape_name, shape, mesh, mesh_name)
    rec.update(record_of(cost, meta, arg), status="ok")
    r = analyze_record(rec)
    return {
        "variant": variant,
        "compute_s": round(r.compute_s, 4),
        "memory_s": round(r.memory_s, 4),
        "collective_s": round(r.collective_s, 4),
        "dominant": r.dominant,
        "roofline_frac": round(r.roofline_frac, 4),
        "hbm_gib": round(rec["memory"]["total_bytes"] / 2 ** 30, 2),
        "fits_hbm": rec["fits_hbm"],
        "flops_per_dev": r.hlo_flops,
        "collective_gb": round(
            rec["hlo"]["collective_bytes_per_device"] / 1e9, 1),
        "by_collective": {
            k: round(b / 1e9, 1) for k, b in list(
                rec["hlo"]["by_collective"].items())[:5]},
        "t_s": round(time.time() - t0, 1),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--variants", default="baseline,fsdp")
    args = ap.parse_args(argv)
    mesh_name = MESH.mesh_name(multi_pod=args.mesh == "multi")
    mesh = MESH.make_production_mesh(multi_pod=args.mesh == "multi")
    for v in args.variants.split(","):
        r = run_variant(args.arch, args.shape, mesh_name, v, mesh=mesh)
        print(json.dumps({"arch": args.arch, "shape": args.shape,
                          "mesh": mesh_name, **r}))


if __name__ == "__main__":
    main()
