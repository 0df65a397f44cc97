"""The port's launch tools against the reference's: abstract inputs and
params, the graph analysis, the roofline formulas, kernel D's custom op
under tracing, and the dry-run CLI on ``tests/test_launch.py``'s cells.

* ``input_specs`` for every cell and ``abstract_params`` for every full
  config: the reference's shapes and dtypes, nothing allocated;
* ``graphanalysis``: a loop of 10 ``(64x128)@(128x128)`` products counts
  exactly ``10*2*64*128*128``; ``_wire_bytes`` equals the reference's;
  each family's reduced prefill on a 1 x 1 mesh within 5 % of the
  reference's ``analyze_hlo`` of the same step compiled here (the
  reference analyzer's own tolerance), and equal to ``FlopCounterMode``
  on the step run on the CPU;
* the unit-depth fit equal to a trace of the whole stack (FLOPs and
  collectives);
* ``model_flops_per_device``, ``_cache_bytes`` and
  ``memory_bytes_per_device`` equal to the reference's for every cell at
  the reference's mesh sizes;
* the dry-run CLI in a subprocess on the two cells of
  ``tests/test_launch.py``: ``ok``, 256 chips, fits, FLOPs > 0, read by
  ``analyze_record``.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.launch import hloanalysis as RH  # noqa: E402
from repro.launch import roofline as RR  # noqa: E402
from repro.launch import steps as RST  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import graphanalysis as GA  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.launch.steps import input_specs, make_prefill_step  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import leaves  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
_DT = {jnp.dtype(jnp.int32): torch.int32,
       jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.float32): torch.float32}


def _ref_leaves(tree):
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    mine = input_specs(cfg, SHAPES[shape])
    theirs = RST.input_specs(rcfg, REF_SHAPES[shape])
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        a, b = leaves(mine[k]), _ref_leaves(theirs[k])
        assert len(a) == len(b), k
        for x, y in zip(a, b):
            assert x.device.type == "meta"
            assert tuple(x.shape) == tuple(y.shape), (k, x.shape, y.shape)
            assert x.dtype == _DT[jnp.dtype(y.dtype)], k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_axes_match_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    mine = leaves(M.abstract_params(cfg))
    theirs = _ref_leaves(RM.abstract_params(rcfg))
    assert [tuple(t.shape) for t in mine] == [tuple(t.shape) for t in theirs]
    assert all(t.device.type == "meta" for t in mine)
    assert {t.dtype for t in mine} == {_DT[jnp.dtype(theirs[0].dtype)]}
    axes = leaves(M.param_axes(cfg))
    raxes = jax.tree.leaves(RM.param_axes(rcfg),
                            is_leaf=lambda x: isinstance(x, tuple))
    assert axes == raxes


def test_arctic_params_build_on_the_meta_device():
    n = sum(t.numel() for t in leaves(M.abstract_params(
        get_config("arctic_480b"))))
    assert n > 4e11


def test_a_loop_of_products_counts_every_product():
    from torch.fx.experimental.proxy_tensor import make_fx

    def f(x, w):
        for _ in range(10):
            x = x @ w
        return x

    g = make_fx(f)(torch.randn(64, 128), torch.randn(128, 128))
    assert GA.analyze_graphs([g]).flops == 10 * 2 * 64 * 128 * 128


@pytest.mark.parametrize("g", [1, 2, 8, 16, 32, 256])
def test_wire_bytes_equal_the_reference(g):
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        for size in (0, 1, 4096, 123456789):
            assert GA._wire_bytes(kind, size, g) == RH._wire_bytes(
                kind, size, g)


_B, _S = 2, 64


def _ref_prefill_flops(rcfg) -> float:
    batch = {"tokens": jax.ShapeDtypeStruct((_B, _S), jnp.int32)}
    dt = jnp.bfloat16 if rcfg.dtype == "bfloat16" else jnp.float32
    if rcfg.family == "vlm":
        batch["vision"] = jax.ShapeDtypeStruct(
            (_B, rcfg.vis_seq, rcfg.d_model), dt)
    if rcfg.kind == "encdec":
        batch["frames"] = jax.ShapeDtypeStruct(
            (_B, rcfg.enc_seq, rcfg.d_model), dt)
    text = jax.jit(RST.make_prefill_step(rcfg)).lower(
        RM.abstract_params(rcfg), batch).compile().as_text()
    return RH.analyze_hlo(text).flops


@pytest.fixture(scope="module")
def mesh1():
    from repro_torch.launch.mesh import fake_mesh

    return fake_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("arch", ["mamba2_780m", "hymba_1_5b",
                                  "deepseek_7b", "minicpm3_4b",
                                  "qwen2_moe_a2_7b", "llama32_vision_11b",
                                  "whisper_large_v3"])
def test_reduced_prefill_flops_match_analyze_hlo(arch, mesh1):
    """One config a family (and MLA): the dry run on a 1 x 1 mesh within
    5 % of the reference's analyzer, and equal to ``FlopCounterMode``
    around the same step run on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_config(arch).reduced()
    cost, _ = dryrun.fitted_cost(cfg, ShapeConfig("prefill_32k", _S, _B,
                                                  "prefill"), mesh1,
                                 full_depth=True)
    ref = _ref_prefill_flops(ref_get_config(arch).reduced())
    assert abs(cost["flops"] - ref) <= 0.05 * ref, (cost["flops"], ref)
    params = M.init_params(cfg, 0, device="cpu")
    dt = M._dtype(cfg)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (_B, _S), generator=gen)}
    if cfg.family == "vlm":
        batch["vision"] = torch.randn(_B, cfg.vis_seq, cfg.d_model,
                                      generator=gen).to(dt)
    if cfg.kind == "encdec":
        batch["frames"] = torch.randn(_B, cfg.enc_seq, cfg.d_model,
                                      generator=gen).to(dt)
    with FlopCounterMode(display=False) as fc:
        make_prefill_step(cfg)(params, batch)
    assert fc.get_total_flops() == cost["flops"]


@pytest.fixture(scope="module")
def mesh4():
    from repro_torch.launch.mesh import fake_mesh

    return fake_mesh((2, 2), ("data", "model"))


@pytest.mark.parametrize("arch,step,layers", [
    ("mamba2_780m", "train", {"n_layers": 3}),
    ("hymba_1_5b", "prefill", {"n_layers": 4, "global_layers": (0, 2)}),
    ("llama32_vision_11b", "decode", {"n_layers": 6}),
    ("whisper_large_v3", "prefill", {"n_layers": 3, "enc_layers": 3}),
])
def test_unit_depth_fit_equals_the_whole_stack(arch, step, layers, mesh4):
    cfg = dataclasses.replace(get_config(arch).reduced(), **layers)
    shape = {"train": ShapeConfig("train_4k", 8, 8, "train"),
             "prefill": ShapeConfig("prefill_32k", 32, 4, "prefill"),
             "decode": ShapeConfig("decode_32k", 32, 4, "decode")}[step]
    mb = 4 if step == "train" else None
    fit, meta = dryrun.fitted_cost(cfg, shape, mesh4, microbatches=mb)
    whole, _ = dryrun.fitted_cost(cfg, shape, mesh4, microbatches=mb,
                                  full_depth=True)
    assert meta["probes"] == (4 if step == "train" else
                              1 + len(dryrun._depth_knobs(cfg)[0]))
    for key in set(fit) | set(whole):
        if key in ("temp_bytes", "traffic_bytes"):
            continue  # a liveness peak and a byte proxy: approximate
        assert fit.get(key, 0.0) == pytest.approx(whole.get(key, 0.0),
                                                  rel=1e-9, abs=1e-6), key
    assert whole["flops"] > 0


def test_ssd_op_traces_on_fake_and_meta_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.ssd_scan import ssd_scan as kd

    b, S, H, P, N = 2, 16, 4, 8, 8
    for mode in (FakeTensorMode(), None):
        dev = "cpu" if mode is not None else "meta"
        with (mode or torch.device("meta")):
            x = torch.empty(b, S, H, P, dtype=torch.bfloat16, device=dev)
            dt = torch.empty(b, S, H, device=dev)
            A, D = torch.empty(H, device=dev), torch.empty(H, device=dev)
            B = torch.empty(b, S, N, dtype=torch.bfloat16, device=dev)
            y, st = kd.ssd_scan_kernel(x, dt, A, B, B, D, chunk=8)
        assert tuple(y.shape) == (b, S, H, P) and y.dtype == torch.bfloat16
        assert tuple(st.shape) == (b, H, P, N) and st.dtype == torch.float32
    assert kd.ssd_scan_flops((b, S, H, P), (b, S, N), 8) == \
        2 * b * S * (8 * N + H * 8 * P + 2 * H * P * N)


def test_ssd_op_sharding_rule_runs_each_shard_locally(mesh4):
    """Batch-sharded on one mesh dim and head-sharded on the other: rank
    0's outputs are the plain version's on its batch and head block."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.ssd_scan import ssd_scan as kd

    kd.register_sharding_rule()
    gen = torch.Generator().manual_seed(0)
    b, S, H, P, N = 4, 16, 4, 8, 8
    x = torch.randn(b, S, H, P, generator=gen)
    dt = torch.rand(b, S, H, generator=gen) * 0.1
    A, D = -torch.rand(H, generator=gen), torch.rand(H, generator=gen)
    B = torch.randn(b, S, N, generator=gen)
    C = torch.randn(b, S, N, generator=gen)
    y0, s0 = kd.ssd_scan_plain(x, dt, A, B, C, D, chunk=8)
    R = Replicate()
    pl = {"x": [Shard(0), Shard(2)], "dt": [Shard(0), Shard(2)],
          "A": [R, Shard(0)], "B": [Shard(0), R], "C": [Shard(0), R],
          "D": [R, Shard(0)]}
    args = [distribute_tensor(t, mesh4, pl[k]) for k, t in
            zip(("x", "dt", "A", "B", "C", "D"), (x, dt, A, B, C, D))]
    y, st = kd.ssd_scan_kernel(*args, chunk=8)
    assert tuple(y.placements) == (Shard(0), Shard(2))
    assert tuple(st.placements) == (Shard(0), Shard(1))
    torch.testing.assert_close(y.to_local(), y0[:2, :, :2], rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(st.to_local(), s0[:2, :2], rtol=1e-6,
                               atol=1e-6)


def test_run_cells_in_process_and_over_a_pool_record_alike(mesh4):
    """One record path: the same cells traced in this process and over a
    pool of worker processes give the same records, a skipped cell
    included."""
    cells = [("mamba2_780m", "decode_32k",
              ShapeConfig("decode_32k", 64, 4, "decode")),
             ("glm4_9b", "long_500k")]
    here = dryrun.run_cells(cells, mesh4, "fake_2x2")
    pool = dryrun._pool(2)
    try:
        there = dryrun.run_cells(cells, mesh4, "fake_2x2", pool)
    finally:
        pool.terminate()
        pool.join()
    assert [r["status"] for r in here] == ["ok", "skipped"]
    for rec in here + there:
        rec.pop("t_trace_s", None)
    assert here == there


def test_fits_hbm_keeps_the_measured_margin():
    """A total under the card's memory but not under it with the margin
    the card measured is not reported as fitting."""
    cost = {"flops": 1.0, "collective_bytes": 0.0, "traffic_bytes": 0.0,
            "n_collectives": 0.0, "temp_bytes": 0.0, "output_bytes": 0.0}
    meta = {"microbatches": None, "t_trace_s": 0.0, "probes": 1, "nodes": 1}
    edge = int(R.HBM_PER_CHIP / dryrun.HBM_MARGIN)
    assert dryrun.record_of(cost, meta, edge - 1)["fits_hbm"] is True
    rec = dryrun.record_of(cost, meta, edge + 1)
    assert rec["memory"]["total_bytes"] < R.HBM_PER_CHIP
    assert rec["fits_hbm"] is False and rec["hbm_margin"] > 1


def test_one_source_for_the_card_rates():
    """The roofline and the planned einsum price with the same numbers."""
    from repro_torch.configs import h100
    from repro_torch.parallel import spmd

    for name in ("PEAK_FLOPS", "NVLINK_BW", "IB_BW", "INTRA_HOST_AXES"):
        assert getattr(spmd, name) is getattr(h100, name), name
        assert getattr(R, name) is getattr(h100, name), name


def _cells():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            yield arch, shape


@pytest.mark.parametrize("mesh_name", ["single_pod_16x16",
                                       "multi_pod_2x16x16"])
def test_roofline_formulas_equal_the_reference(mesh_name):
    sizes = R.mesh_sizes_of({"mesh": mesh_name})
    n = 0
    for arch, shape in _cells():
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        sh, rsh = SHAPES[shape], REF_SHAPES[shape]
        assert R.model_flops_per_device(cfg, sh, sizes) == \
            RR.model_flops_per_device(rcfg, rsh, mesh_name)
        assert R.memory_bytes_per_device(cfg, sh, sizes) == \
            RR.memory_bytes_per_device(rcfg, rsh, mesh_name)
        if sh.step == "decode":
            assert R._cache_bytes(cfg, sh) == RR._cache_bytes(rcfg, rsh)
        n += 1
    assert n == 40


def test_analyze_record_reads_a_reference_shaped_record():
    rec = {"arch": "mamba2_780m", "shape": "decode_32k",
           "mesh": "single_pod_16x16", "status": "ok", "fits_hbm": True,
           "hlo": {"flops_per_device": 1e9,
                   "collective_bytes_per_device": 5e7}}
    row = R.analyze_record(rec)
    assert row.collective_s == pytest.approx(5e7 / R.IB_BW)
    assert row.compute_s == pytest.approx(1e9 / R.PEAK_FLOPS)
    assert row.dominant in ("compute", "memory", "collective")


def test_hillclimb_variants_are_the_reference_s():
    """The variants' rules and knobs, read from the reference's source
    (its module forces 512 host devices on import)."""
    from repro_torch.launch.hillclimb import VARIANTS

    tree = ast.parse((REPO / "src/repro/launch/hillclimb.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.AnnAssign)
                and getattr(n.target, "id", "") == "VARIANTS")
    ref = ast.literal_eval(node.value)
    assert json.loads(json.dumps(VARIANTS)) == json.loads(json.dumps(ref))


def test_train_overrides_are_the_reference_s():
    tree = ast.parse((REPO / "src/repro/launch/dryrun.py").read_text())
    vals = {}
    for n in tree.body:
        if isinstance(n, (ast.Assign, ast.AnnAssign)):
            tgt = n.targets[0] if isinstance(n, ast.Assign) else n.target
            if getattr(tgt, "id", "") in ("TRAIN_OVERRIDES",
                                          "TRAIN_ROWS_PER_DEVICE"):
                vals[tgt.id] = ast.literal_eval(n.value)
    assert vals == {"TRAIN_OVERRIDES": dryrun.TRAIN_OVERRIDES,
                    "TRAIN_ROWS_PER_DEVICE": dryrun.TRAIN_ROWS_PER_DEVICE}


def _run_cli(args, tmp_path, timeout=240):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run([sys.executable, *args], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("arch,shape", [("mamba2_780m", "decode_32k"),
                                        ("hymba_1_5b", "long_500k")])
def test_dryrun_cli_cell(arch, shape, tmp_path):
    out = tmp_path / "dryrun.json"
    proc = _run_cli(["-m", "repro_torch.launch.dryrun", "--arch", arch,
                     "--shape", shape, "--mesh", "single", "--out",
                     str(out)], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    recs = json.loads(out.read_text())
    assert len(recs) == 1
    rec = recs[0]
    assert rec["status"] == "ok", rec
    assert rec["chips"] == 256
    assert rec["mesh_sizes"] == {"data": 32, "model": 8}
    assert rec["fits_hbm"] is True
    assert rec["hlo"]["flops_per_device"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    row = R.analyze_record(rec)
    assert row.dominant in ("compute", "memory", "collective")
    assert row.bound() > 0
    # resumable: an ok cell is not traced again
    again = _run_cli(["-m", "repro_torch.launch.dryrun", "--arch", arch,
                      "--shape", shape, "--mesh", "single", "--out",
                      str(out)], tmp_path)
    assert again.returncode == 0 and "single_pod" not in again.stdout


def test_dryrun_cli_records_a_failed_cell_and_exits_1(tmp_path):
    """A cell that fails to trace is recorded as an error, never skipped
    quietly, and the CLI exits 1."""
    script = (
        "import sys\n"
        "import repro_torch.launch.dryrun as d\n"
        "def broken(*a, **k):\n"
        "    raise RuntimeError('no trace')\n"
        "d.trace_cell = broken\n"
        "d.main(sys.argv[1:])\n")
    out = tmp_path / "dryrun.json"
    proc = _run_cli(["-c", script, "--arch", "mamba2_780m", "--shape",
                     "decode_32k,long_500k", "--mesh", "single", "--out",
                     str(out)], tmp_path)
    assert proc.returncode == 1
    recs = json.loads(out.read_text())
    assert [r["status"] for r in recs] == ["error", "error"]
    assert "no trace" in recs[0]["error"]


def test_roofline_cli_writes_the_table(tmp_path):
    rec = {"arch": "glm4_9b", "shape": "long_500k", "mesh": "single_pod_32x8",
           "status": "skipped", "reason": "quadratic"}
    (tmp_path / "d.json").write_text(json.dumps([rec]))
    R.main(["--results", str(tmp_path / "d.json"), "--out",
            str(tmp_path / "r.md")])
    assert "skipped" in (tmp_path / "r.md").read_text()


def test_numpy_is_the_only_bridge():
    """The launch modules import neither jax nor the reference."""
    for mod in (dryrun, GA, R):
        src = Path(mod.__file__).read_text()
        assert "import jax" not in src and "from repro." not in src
    assert np.__name__ == "numpy"


def test_hillclimb_runs_a_variant_row():
    from repro_torch.launch import hillclimb
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    row = hillclimb.run_variant("mamba2_780m", "long_500k",
                                "single_pod_32x8", "baseline", mesh=mesh)
    assert row["dominant"] in ("compute", "memory", "collective")
    assert row["flops_per_dev"] > 0 and row["hbm_gib"] > 0
    assert set(row) >= {"compute_s", "memory_s", "collective_s",
                        "roofline_frac", "collective_gb", "by_collective"}
