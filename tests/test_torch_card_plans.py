"""The planner's card budget: the H100 model of what kernels A and B hold.

``CARD_BUDGET`` is the default of every planning entry point of the port;
``REFERENCE_BUDGET`` (the reference's 16 MiB TPU VMEM) is the named parity
setting.  Checked here on the CPU:

* the DP (``partition_segment``) equals its brute-force oracle under both
  budgets for every fusable segment of the four zoo models at full size,
  batch 1 and 8, float32 and bfloat16, and under the reference's budget the
  oracle equals the reference's own;
* the card model's bytes of every launch of those plans equal what the
  kernel's wrapper (``prepare_launch``) allocates on a 264-block grid,
  built on the meta device (nothing is allocated);
* a batch past the kernel's 32-bit scratch indices is refused at plan time;
* every entry point defaults to the card budget, and plans under it run
  end to end against the reference's ``reference_network``;
* ``configs.all_configs`` and ``configs.shapes.cells`` equal the
  reference's.
"""

import dataclasses
import inspect
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import all_configs as j_all_configs  # noqa: E402
from repro.configs.shapes import cells as j_cells  # noqa: E402
from repro.net import graph as jgraph  # noqa: E402
from repro.net import partition as jpart  # noqa: E402
from repro_torch.configs import all_configs, cells, h100  # noqa: E402
from repro_torch.core import program as tprog  # noqa: E402
from repro_torch.core.program import (  # noqa: E402
    CARD_BUDGET,
    REFERENCE_BUDGET,
    CardBudget,
    LaunchPlan,
    TpuVmemBudget,
    card_layout,
    compile_program,
)
from repro_torch.kernels.fused_conv import fused_conv as fc  # noqa: E402
from repro_torch.kernels.fused_conv import ops  # noqa: E402
from repro_torch.net import graph as tgraph  # noqa: E402
from repro_torch.net import partition as tpart  # noqa: E402
from repro_torch.net import runner as trunner  # noqa: E402
from repro_torch.net import serve as tserve  # noqa: E402
from repro_torch.obs import explain  # noqa: E402
from repro_torch.robust import (  # noqa: E402
    BudgetError,
    GuardConfig,
    guarding,
    inject,
    preflight,
)

from test_torch_network import _model  # noqa: E402

MODELS = sorted(jgraph.MODELS)
DTYPES = ("float32", "bfloat16")
GRID = h100.PYRAMID_GRID
REPO = pathlib.Path(__file__).resolve().parents[1]


def _cost(budget, launches, batch):
    costs = [budget.cost(lp, batch) for lp in launches]
    return sum(c[0] for c in costs), sum(c[1] for c in costs)


# ---------------------------------------------------------------------------
# the DP against its oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", MODELS)
def test_dp_equals_the_oracle_on_the_card(model, dtype, batch):
    """Every fusable segment at full size: the DP's summed cost equals the
    exhaustive minimum exactly (the card's costs are integers), its
    launches tile the segment, and each fits the card budget."""
    graph = tgraph.MODELS[model](compute_dtype=dtype)
    for seg in tgraph.fusable_segments(graph):
        launches = tpart.partition_segment(seg, batch=batch,
                                           compute_dtype=dtype)
        want = tpart.brute_force_segment(seg, batch=batch,
                                         compute_dtype=dtype)
        assert _cost(CARD_BUDGET, launches, batch) == want
        assert isinstance(want[0], int) and isinstance(want[1], int)
        assert sum(len(lp.spec.levels) for lp in launches) == len(seg.nodes)
        for lp in launches:
            assert CARD_BUDGET.fits(lp, batch)
            assert (lp.streamed, lp.x_slots, lp.w_slots, lp.c_tiles) == (
                False, 1, 1, 1)
            if lp.program.q_convs > 1:
                assert lp.card_bytes(batch) <= CARD_BUDGET.nbytes


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", MODELS)
def test_dp_and_oracle_equal_the_references_under_its_budget(model, dtype,
                                                             batch):
    """Under the reference's budget the port's oracle equals the
    reference's ``brute_force_segment`` and the port's DP reaches it."""
    jsegs = jgraph.fusable_segments(jgraph.MODELS[model]())
    tsegs = tgraph.fusable_segments(tgraph.MODELS[model]())
    for jseg, tseg in zip(jsegs, tsegs, strict=True):
        want = jpart.brute_force_segment(jseg, batch=batch,
                                         compute_dtype=dtype)
        got = tpart.brute_force_segment(tseg, budget=REFERENCE_BUDGET,
                                        batch=batch, compute_dtype=dtype)
        assert got == want
        launches = tpart.partition_segment(tseg, budget=REFERENCE_BUDGET,
                                           batch=batch, compute_dtype=dtype)
        assert _cost(REFERENCE_BUDGET, launches, batch) == pytest.approx(want)


def test_oracle_reports_an_infeasible_segment():
    seg = tgraph.fusable_segments(tgraph.lenet5())[0]
    tiny = dataclasses.replace(REFERENCE_BUDGET, nbytes=256)
    assert tpart.brute_force_segment(seg, budget=tiny) == tpart.INFEASIBLE


# ---------------------------------------------------------------------------
# one footprint for the plan and the kernel
# ---------------------------------------------------------------------------


def _allocated(lp: LaunchPlan, batch: int, monkeypatch) -> int:
    """What ``prepare_launch`` allocates for ``lp`` at ``batch`` besides its
    input and output, on the meta device and a ``GRID``-block grid."""
    prog = lp.program
    cdt = torch.float32 if prog.compute_dtype == "float32" else torch.bfloat16
    meta = torch.device("meta")
    kernel = fc.PYRAMID_KTILED if lp.c_tiles > 1 else fc.PYRAMID
    monkeypatch.setattr(kernel, "resident_blocks", lambda code, dev: GRID)
    x = torch.empty((batch, prog.padded_input, prog.padded_input,
                     prog.levels[0].n_in), dtype=cdt, device=meta)
    ws = [torch.empty((p.K, p.K, p.n_in, p.n_out), dtype=cdt, device=meta)
          for p in prog.levels]
    bs = [torch.empty((p.n_out,), dtype=cdt, device=meta)
          for p in prog.levels]
    _, _, desc, bufs = fc.prepare_launch(x, ws, bs, prog, True, True,
                                         lp.c_tiles, None, cdt)
    lay = card_layout(prog, batch, GRID)
    assert desc[10] == lay.cap and desc[11] == GRID
    assert bufs[5].numel() == lay.scratch_vals
    held = (bufs[1], bufs[2], *bufs[5:])  # w, b, scratch, partial, live, bar
    return sum(t.numel() * t.element_size() for t in held)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", MODELS)
def test_card_bytes_equal_the_wrappers_allocation(model, dtype, batch,
                                                  monkeypatch):
    """Every launch of the zoo's plans under both budgets (the reference's
    cover alpha > 1 and channel-tiled launches)."""
    graph = tgraph.MODELS[model](compute_dtype=dtype)
    for budget in (CARD_BUDGET, REFERENCE_BUDGET):
        plan = tpart.auto_partition(graph, batch=batch, budget=budget)
        for pyr in plan.pyramids:
            lp = pyr.launch
            assert lp.card_bytes(batch) == _allocated(lp, batch, monkeypatch)


def test_descriptor_reads_the_planners_layout():
    """The wrapper's descriptor carries the planner's tiles and splits."""
    plan = tpart.auto_partition(tgraph.resnet18(), batch=1)
    for pyr in plan.pyramids:
        prog = pyr.launch.program
        desc, cap, partial = fc._descriptor(prog, True, True, 1, 1, GRID)
        lay = card_layout(prog, 1, GRID)
        assert (cap, partial) == (lay.cap, lay.partial)
        fields = [desc[fc._HEADER + fc._PER_LEVEL * l:][:fc._PER_LEVEL]
                  for l in range(prog.q_convs)]
        assert [f[-2] for f in fields] == list(lay.splits)
        assert [f[-1] for f in fields] == list(lay.tiles)


def test_a_batch_past_32_bits_is_refused_at_plan_time():
    """VGG-16's CONV1 alone at batch 256 needs 3 * 256 * 224^2 * 64 scratch
    values, past 2^31: the wrapper would raise ValueError at launch, the
    card budget refuses the plan with BudgetError naming its model."""
    graph = tgraph.vgg16()
    conv1 = tgraph.fusable_segments(graph)[0].spec().levels[:1]
    prog = compile_program(tprog.FusionSpec(levels=conv1, input_size=224),
                           224)
    with pytest.raises(ValueError, match="32 bits"):
        fc._descriptor(prog, True, True, 1, 256, GRID)
    assert not card_layout(prog, 256).within_index_limit()
    with pytest.raises(BudgetError, match="h100_l2.*32-bit") as err:
        tpart.auto_partition(graph, batch=256)
    assert err.value.context["card_budget"] == CARD_BUDGET.nbytes
    # the reference's model knows no such limit: its plan stands
    tpart.auto_partition(graph, batch=256, budget=REFERENCE_BUDGET)


def test_fused_pyramid_checks_the_card_budget_at_its_batch():
    """A fused launch that fits at batch 1 is refused once its batch busts
    the budget; a one-group launch never is."""
    seg = tgraph.fusable_segments(tgraph.lenet5())[0]
    spec = seg.spec()
    lp = tprog.plan_launch(spec)
    need = lp.card_bytes(2)
    tight = dataclasses.replace(CARD_BUDGET, nbytes=need - 1)
    x = torch.zeros((2, 32, 32, 1))
    ws = [torch.zeros((lvl.K, lvl.K, lvl.n_in, lvl.n_out))
          for lvl in spec.levels if lvl.kind == "conv"]
    bs = [torch.zeros((w.shape[-1],)) for w in ws]
    ops.fused_pyramid(x[:1], ws, bs, spec=spec, budget=tight,
                      out_region=lp.out_region)
    with pytest.raises(BudgetError, match="h100_l2") as err:
        ops.fused_pyramid(x, ws, bs, spec=spec, budget=tight,
                          out_region=lp.out_region)
    assert err.value.context == {"card_budget": need - 1, "card_bytes": need}
    chunks = ops.plan_chunks(spec, budget=tight, batch=2)
    assert [c.q_convs for c in chunks] == [1, 1]
    y, skips = ops.fused_pyramid_chain(x, ws, bs, spec=spec, budget=tight)
    assert y.shape[0] == 2 and len(skips) == 2


# ---------------------------------------------------------------------------
# the defaults
# ---------------------------------------------------------------------------


_PLANNERS = [
    (tprog.plan_launch, "budget"), (tprog.pick_out_region, "budget"),
    (tpart.partition_segment, "budget"), (tpart.brute_force_segment, "budget"),
    (tpart.replan_pyramid, "budget"), (tpart.auto_partition, "budget"),
    (tpart.layerwise_partition, "budget"), (tpart.paper_partition, "budget"),
    (tpart.min_budget, "budget"), (ops.fused_pyramid, "budget"),
    (ops.plan_chunks, "budget"), (ops.fused_pyramid_chain, "budget"),
]


@pytest.mark.parametrize("fn,arg", _PLANNERS,
                         ids=[f.__name__ for f, _ in _PLANNERS])
def test_every_planner_defaults_to_the_card(fn, arg):
    assert inspect.signature(fn).parameters[arg].default is CARD_BUDGET


def test_plans_and_engines_default_to_the_card():
    plan = tpart.auto_partition(tgraph.lenet5())
    assert plan.budget is CARD_BUDGET
    assert tserve.ServeConfig().budget is CARD_BUDGET
    eng = tserve.ServingEngine(tgraph.lenet5(), trunner.init_network_params(
        tgraph.lenet5(), seed=0, device="cpu"), tserve.ServeConfig(
        buckets=(2,)), device="cpu")
    assert eng._entry(2).plan.budget is CARD_BUDGET


def test_the_card_budget_is_the_cards_number():
    assert CARD_BUDGET == CardBudget(h100.PLAN_BUDGET_BYTES)
    assert h100.PLAN_BUDGET_BYTES == h100.L2_BYTES
    assert REFERENCE_BUDGET == TpuVmemBudget(16 * 1024 * 1024)
    assert h100.PYRAMID_GRID == 264


def test_sixteen_mib_is_only_the_reference_setting():
    """No module of the port defaults to the reference's 16 MiB: the value
    appears once, in REFERENCE_BUDGET."""
    pattern = re.compile(r"16 \* 1024 \* 1024|16777216|16_777_216|1 << 24")
    hits = [(p.relative_to(REPO), line.strip())
            for p in sorted((REPO / "src" / "repro_torch").rglob("*.py"))
            for line in p.read_text().splitlines() if pattern.search(line)]
    assert hits == [(pathlib.Path("src/repro_torch/core/program.py"),
                     "REFERENCE_BUDGET = TpuVmemBudget(16 * 1024 * 1024)")]


def test_explain_plans_under_the_card_unless_asked(capsys):
    assert explain.main(["--model", "lenet"]) == 0
    card = capsys.readouterr().out
    assert "card budget" in card and " card " in card.splitlines()[1]
    assert explain.main(["--model", "lenet", "--budget", "reference"]) == 0
    ref = capsys.readouterr().out
    assert "vmem budget 16,384K" in ref and " vmem " in ref.splitlines()[1]


def test_preflight_checks_the_plans_card_budget_at_the_requests_batch():
    """A plan made at batch 1 under the card budget: preflight passes at
    batch 1 and names the card model when a larger batch busts it."""
    graph = tgraph.lenet5()
    plan = tpart.auto_partition(graph, batch=1)
    params = trunner.prepare_network_params(
        plan, trunner.init_network_params(graph, seed=0, device="cpu"))
    need = plan.pyramids[0].launch.card_bytes(1)
    assert plan.pyramids[0].q_convs == 2
    tight = dataclasses.replace(CARD_BUDGET, nbytes=need)
    x1, x2 = torch.zeros((1, 32, 32, 1)), torch.zeros((2, 32, 32, 1))
    assert preflight(x1, params, plan=plan, budget=tight) == "float32"
    with pytest.raises(BudgetError, match="h100_l2") as err:
        preflight(x2, params, plan=plan, budget=tight)
    assert set(err.value.context) == {"launch", "card_budget", "card_bytes"}
    assert preflight(x2, params, plan=plan) == "float32"


def test_degrade_ladder_replans_under_the_card_budget():
    """A squeeze below the fused launch's card bytes: the replan rung cuts
    it into one-group launches, which always fit on the card."""
    graph = tgraph.lenet5()
    plan = tpart.auto_partition(graph, batch=1)
    master = trunner.init_network_params(graph, seed=0, device="cpu")
    params = trunner.prepare_network_params(plan, master)
    x = torch.randn((1, 32, 32, 1), generator=torch.Generator().manual_seed(0))
    need = plan.pyramids[0].launch.card_bytes(1)
    with guarding(GuardConfig(), source_params=master) as guard:
        with inject(seed=0) as inj:
            inj.squeeze_budget(need / 2 / CARD_BUDGET.nbytes)
            y, _ = trunner.run_network(x, params, plan=plan)
    rep = guard.last_report
    assert rep.fallback_counts() == {"replan": 1}
    assert rep.events[0].detail["sub_launches"] == ["CL1..MPL1", "CL2..MPL2"]
    ref = trunner.reference_network(x, graph, master)
    assert float((y - ref).abs().max()) <= 1e-4 * max(1.0,
                                                      float(ref.abs().max()))


# ---------------------------------------------------------------------------
# the card's plans end to end, and what they cost
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["auto", "layerwise"])
@pytest.mark.parametrize("name", ["alexnet", "lenet", "resnet18", "vgg16"])
def test_card_plans_match_the_reference_network(name, kind):
    """The reduced zoo models under the card's auto and layerwise plans
    against the reference's ``reference_network`` (f32 logits within
    1e-4, the runner's contract)."""
    tg, tp, x, ref = _model(name)
    planner = (tpart.auto_partition if kind == "auto"
               else tpart.layerwise_partition)
    plan = planner(tg, batch=x.shape[0])
    assert plan.budget is CARD_BUDGET
    logits, skips = trunner.run_network(
        torch.from_numpy(x), trunner.prepare_network_params(plan, tp),
        plan=plan)
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4)
    assert list(skips) == [p.name for p in plan.pyramids]


def test_card_cuts_move_with_the_batch():
    """VGG-16 at full size: batch 1 fuses deeper than batch 8, because its
    fused launches would bust the budget at batch 8; both move fewer HBM
    bytes than the layerwise plan at their batch."""
    b1 = tpart.auto_partition(tgraph.vgg16(), batch=1)
    b8 = tpart.auto_partition(tgraph.vgg16(), batch=8)
    assert b8.n_launches() > b1.n_launches()
    assert max(p.q_convs for p in b8.pyramids) < max(
        p.q_convs for p in b1.pyramids)
    assert any(p.q_convs > 1 and not CARD_BUDGET.fits(p.launch, 8)
               for p in b1.pyramids)
    for plan, batch in ((b1, 1), (b8, 8)):
        layerwise = tpart.layerwise_partition(tgraph.vgg16(), batch=batch)
        assert plan.hbm_bytes() < layerwise.hbm_bytes()


def test_card_tie_break_is_the_roofline_at_the_cards_rates():
    """The second cost is max(bytes / HBM_BW, FLOPs / peak) in units of
    1 / (HBM_BW * peak) seconds, the peak of the launch's dtype (not the
    TPU MXU's 2x bf16 ratio)."""
    for dtype in DTYPES:
        graph = tgraph.resnet18(compute_dtype=dtype)
        lp = tpart.auto_partition(graph, batch=8).pyramids[1].launch
        hbm, t = CARD_BUDGET.cost(lp, 8)
        bw, peak = h100.HBM_BW, h100.PEAK_FLOPS_BY_TYPE[dtype]
        assert hbm == lp.hbm_bytes(8)
        assert t / (bw * peak) == pytest.approx(
            max(hbm / bw, lp.card_flops(8) / peak))
    assert REFERENCE_BUDGET.cost(lp, 8) == (float(lp.hbm_bytes(8)),
                                            float(lp.modeled_cycles(8)))


def test_describe_reports_the_budgets_working_set():
    lp = tpart.auto_partition(tgraph.lenet5()).pyramids[0].launch
    row = lp.describe(1, CARD_BUDGET)
    assert row["vmem_bytes"] == lp.card_bytes(1)
    assert row["vmem_headroom_bytes"] == CARD_BUDGET.nbytes - lp.card_bytes(1)
    assert lp.describe(1)["vmem_bytes"] == lp.vmem_bytes()


def test_budget_values():
    # the model is the class: equal bytes under two models differ
    assert CardBudget(1 << 20) != TpuVmemBudget(1 << 20)
    assert CARD_BUDGET.context(7) == {"card_budget": CARD_BUDGET.nbytes,
                                      "card_bytes": 7}
    assert REFERENCE_BUDGET.context() == {"vmem_budget": 16 * 1024 * 1024}
    half = CARD_BUDGET.scaled(0.5)
    assert half == CardBudget(CARD_BUDGET.nbytes // 2)
    assert "h100_l2" in str(CARD_BUDGET) and "tpu_vmem" in str(
        REFERENCE_BUDGET)
    assert tpart.min_budget(tgraph.vgg16()).nbytes == 0
    assert tpart.min_budget(tgraph.vgg16(),
                            budget=REFERENCE_BUDGET).nbytes == \
        jpart.min_vmem_budget(jgraph.vgg16())


# ---------------------------------------------------------------------------
# the last reference names
# ---------------------------------------------------------------------------


def test_all_configs_equal_the_references():
    ours, theirs = all_configs(), j_all_configs()
    assert list(ours) == list(theirs)
    for arch in ours:
        assert dataclasses.asdict(ours[arch]) == dataclasses.asdict(
            theirs[arch])


def test_cells_equal_the_references():
    ours = [(a, s.name, ok, why) for a, _, s, ok, why in cells(all_configs())]
    theirs = [(a, s.name, ok, why)
              for a, _, s, ok, why in j_cells(j_all_configs())]
    assert ours == theirs
    assert sum(ok for *_, ok, _ in ours) == 32
