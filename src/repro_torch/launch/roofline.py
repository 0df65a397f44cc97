"""Roofline analysis over dry-run records, on the NVIDIA H100.

The port of the reference's ``repro.launch.roofline``, with the H100's
numbers in place of its TPU's.  Per (arch x shape x mesh) cell, three
per-card time terms:

  compute    = graph FLOPs a device / PEAK_FLOPS
  memory     = analytic HBM bytes a device / HBM_BW
  collective = wire bytes on NVLink / NVLINK_BW + the rest / IB_BW

FLOPs and collective bytes come from :mod:`repro_torch.launch.graphanalysis`
over the dry run's per-rank graphs.  A collective whose process group
stays inside the ``model`` axis (the 8 cards of one host) runs over
NVLink; any other crosses hosts over InfiniBand.  A record of the
reference's dry run has no such split, and all its bytes are priced at
the InfiniBand rate.

The memory term is analytic, with the reference's formulas:

  train:   params(2 reads: fwd+bwd) + grad write+read + moments r/w +
           param write + residual-stack write+read+recompute-read
           (3 x L x local x-bytes)
  prefill: params read + 2 x L x local activation bytes
  decode:  params read (streamed per token) + KV/state cache read

MODEL_FLOPS = 6*N*D for train (N = active params for MoE), 2*N*D prefill,
2*N per token decode (D = tokens); attention is excluded by convention, so
MODEL_FLOPS / graph FLOPs shows remat, attention and dispatch overhead.
Chips and data-parallel shards come from the record's mesh sizes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.h100 import (  # noqa: F401  (re-exported)
    HBM_BW,
    HBM_PER_CHIP,
    IB_BW,
    INTRA_HOST_AXES,
    NVLINK_BW,
    PEAK_FLOPS,
    PEAK_FLOPS_BY_TYPE,
)

_MOMENT_BYTES = {"float32": 4, "bfloat16": 2}

# the reference's mesh names, read when a record has no "mesh_sizes"
_REFERENCE_MESHES = {"single_pod_16x16": {"data": 16, "model": 16},
                     "multi_pod_2x16x16": {"pod": 2, "data": 16,
                                           "model": 16}}


def mesh_sizes_of(rec_or_sizes) -> dict[str, int]:
    """A record's mesh sizes (``rec["mesh_sizes"]``, or the reference's
    named meshes), or the sizes mapping itself."""
    if "mesh" in rec_or_sizes or "mesh_sizes" in rec_or_sizes:
        if "mesh_sizes" in rec_or_sizes:
            return dict(rec_or_sizes["mesh_sizes"])
        return dict(_REFERENCE_MESHES[rec_or_sizes["mesh"]])
    return dict(rec_or_sizes)


def _chips(sizes: dict[str, int]) -> int:
    n = 1
    for v in sizes.values():
        n *= v
    return n


def _dp_shards(sizes: dict[str, int]) -> int:
    return sizes.get("data", 1) * sizes.get("pod", 1)


def model_flops_per_device(cfg, shape, sizes: dict[str, int]) -> float:
    n_active = cfg.active_param_count()
    chips = _chips(sizes)
    if shape.step == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n_active * d / chips
    if shape.step == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n_active * d / chips
    return 2.0 * n_active * shape.global_batch / chips  # decode: per step


def _cache_bytes(cfg, shape) -> float:
    """Global KV/state cache bytes for a decode shape."""
    B, S = shape.global_batch, shape.seq_len
    bpe = 2  # bf16
    L = cfg.n_layers
    if cfg.family == "ssm":
        conv = (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state)
        state = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
        return L * B * (conv + state) * bpe
    if cfg.family == "hybrid":
        attn = L * B * S * 2 * cfg.n_kv_heads * cfg.d_head * bpe
        conv = (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state)
        state = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
        return attn + L * B * (conv + state) * bpe
    if cfg.attn_kind == "mla":
        return L * B * S * (cfg.kv_lora_rank + cfg.d_rope) * bpe
    kv = L * B * S * 2 * cfg.n_kv_heads * cfg.d_head * bpe
    if cfg.kind == "encdec":
        kv += L * B * cfg.enc_seq * 2 * cfg.n_kv_heads * cfg.d_head * bpe
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.cross_every
        kv += n_cross * B * cfg.vis_seq * 2 * cfg.n_kv_heads * cfg.d_head * bpe
    return kv


def memory_bytes_per_device(cfg, shape, sizes: dict[str, int], *,
                            microbatches=1) -> float:
    chips = _chips(sizes)
    p_total = cfg.param_count()
    p_loc = p_total * 2 / chips  # bf16 shard
    mom = _MOMENT_BYTES[cfg.moment_dtype]
    if shape.step == "train":
        tokens_loc = shape.global_batch * shape.seq_len / _dp_shards(sizes)
        act = 3.0 * cfg.n_layers * tokens_loc * cfg.d_model * 2
        opt = p_total / chips * (4 + 2 * 2 * mom)  # grads fp32 + moments r/w
        return 2 * p_loc + p_loc + opt + act
    if shape.step == "prefill":
        tokens_loc = shape.global_batch * shape.seq_len / _dp_shards(sizes)
        return p_loc + 2.0 * cfg.n_layers * tokens_loc * cfg.d_model * 2
    cache = _cache_bytes(cfg, shape) / chips
    return p_loc + cache  # decode: stream params + read cache


def collective_seconds(hlo: dict) -> float:
    """Wire time of a record's collectives: NVLink for the bytes whose
    groups stay inside :data:`INTRA_HOST_AXES`, InfiniBand for the rest."""
    total = hlo["collective_bytes_per_device"]
    by_axes = hlo.get("collective_bytes_by_axes", {})
    intra = sum(v for k, v in by_axes.items()
                if set(k.split("+")) <= set(INTRA_HOST_AXES))
    return intra / NVLINK_BW + (total - intra) / IB_BW


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0
    hlo_flops: float = 0.0
    useful_ratio: float = 0.0
    roofline_frac: float = 0.0  # compute / max(all terms): fraction of peak
    fits: bool | None = None
    note: str = ""

    def bound(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


_MOVES = {
    "compute": "cut remat recompute / attention flops (fused kernels, "
               "policy='dots'), or grow per-chip batch",
    "memory": "shard or shrink the streamed state (SP residuals, smaller "
              "moments, ring-buffer window caches)",
    "collective": "reshard to cheaper collectives (SP reduce-scatter, "
                  "grad-compression over 'pod', overlap with compute)",
}


def analyze_record(rec: dict) -> RooflineRow:
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    if "seq_len" in rec:  # a record of other sizes than the named shape's
        shape = replace(shape, seq_len=rec["seq_len"],
                        global_batch=rec["global_batch"])
    row = RooflineRow(rec["arch"], rec["shape"], rec["mesh"], rec["status"])
    if rec["status"] != "ok":
        row.note = rec.get("reason", rec.get("error", ""))
        return row
    sizes = mesh_sizes_of(rec)
    h = rec["hlo"]
    row.hlo_flops = h["flops_per_device"]
    row.compute_s = row.hlo_flops / PEAK_FLOPS
    row.memory_s = memory_bytes_per_device(cfg, shape, sizes) / HBM_BW
    row.collective_s = collective_seconds(h)
    row.model_flops = model_flops_per_device(cfg, shape, sizes)
    row.useful_ratio = row.model_flops / max(row.hlo_flops, 1.0)
    terms = {"compute": row.compute_s, "memory": row.memory_s,
             "collective": row.collective_s}
    row.dominant = max(terms, key=terms.get)
    # useful model flops-time over the binding term
    row.roofline_frac = (row.model_flops / PEAK_FLOPS) / max(row.bound(),
                                                             1e-12)
    row.fits = rec.get("fits_hbm")
    return row


def load_rows(path: str | Path) -> list[RooflineRow]:
    recs = json.loads(Path(path).read_text())
    return [analyze_record(r) for r in recs]


def markdown_table(rows: list[RooflineRow]) -> str:
    hdr = (
        "| arch | shape | mesh | compute s | memory s | collective s | "
        "dominant | MODEL/HLO flops | roofline frac | fits | what moves it |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        if r.status == "skipped":
            lines.append(
                f"| {r.arch} | {r.shape} | {r.mesh} | — | — | — | skipped "
                f"| — | — | — | {r.note[:60]} |"
            )
            continue
        if r.status == "error":
            lines.append(
                f"| {r.arch} | {r.shape} | {r.mesh} | ERR | | | {r.note[:40]} | | | | |"
            )
            continue
        lines.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.4f} | "
            f"{r.memory_s:.4f} | {r.collective_s:.4f} | **{r.dominant}** | "
            f"{r.useful_ratio:.2f} | {r.roofline_frac:.3f} | "
            f"{'y' if r.fits else 'n'} | {_MOVES[r.dominant]} |"
        )
    return hdr + "\n".join(lines) + "\n"


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun.json")
    ap.add_argument("--out", default="results/roofline.md")
    args = ap.parse_args(argv)
    rows = load_rows(args.results)
    md = markdown_table(rows)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(md)
    print(md)


if __name__ == "__main__":
    main()
