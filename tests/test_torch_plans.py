"""Plan parity: the port's tile-program compiler, launch planner and
auto-partitioner against the reference's, field by field.

Both packages are pure Python over static shapes here, so every
``TileProgram`` / ``LaunchPlan`` / ``PartitionPlan`` must be *equal* (as
nested dicts of their dataclass fields), and so must every modeled byte
and cycle count — the port runs exactly the reference's plans.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core import program as jprog  # noqa: E402
from repro.net import graph as jgraph  # noqa: E402
from repro.net import partition as jpart  # noqa: E402
from repro.robust.errors import BudgetError as JBudgetError  # noqa: E402
from repro.robust.errors import PlanError as JPlanError  # noqa: E402
from repro_torch.core import program as tprog  # noqa: E402
from repro_torch.net import graph as tgraph  # noqa: E402
from repro_torch.net import partition as tpart  # noqa: E402
from repro_torch.robust.errors import BudgetError, PlanError  # noqa: E402

MODELS = sorted(jgraph.MODELS)
DTYPES = ("float32", "bfloat16")


def _fields(obj):
    return dataclasses.asdict(obj)


def _segment_specs(model, input_size=None):
    kw = {} if input_size is None else {"input_size": input_size}
    jsegs = jgraph.fusable_segments(jgraph.MODELS[model](**kw))
    tsegs = tgraph.fusable_segments(tgraph.MODELS[model](**kw))
    assert [_fields(s) for s in jsegs] == [_fields(s) for s in tsegs]
    return [(j.spec(), t.spec()) for j, t in zip(jsegs, tsegs)]


@pytest.mark.parametrize("model", MODELS)
def test_zoo_graphs_equal(model):
    for size in (None, 32 if model != "alexnet" else 67):
        kw = {} if size is None else {"input_size": size}
        jg, tg = jgraph.MODELS[model](**kw), tgraph.MODELS[model](**kw)
        assert _fields(jg) == _fields(tg)
        assert {k: _fields(v) for k, v in jgraph.infer_shapes(jg).items()} == {
            k: _fields(v) for k, v in tgraph.infer_shapes(tg).items()
        }


@pytest.mark.parametrize("model", MODELS)
def test_compile_program_every_region(model):
    """Every zoo segment, every exactly-tiling region, both dtypes: equal
    programs and equal byte/cycle models."""
    for jspec, tspec in _segment_specs(model):
        assert _fields(jspec) == _fields(tspec)
        out = jspec.feature_sizes()[-1]
        for r in (r for r in range(1, out + 1) if out % r == 0):
            for dt in DTYPES:
                jp = jprog.compile_program(jspec, r, compute_dtype=dt)
                tp = tprog.compile_program(tspec, r, compute_dtype=dt)
                assert _fields(jp) == _fields(tp)
                for xs in (1, 2):
                    assert jp.vmem_bytes(xs) == tp.vmem_bytes(xs)
                    assert jp.vmem_stream_bytes(2, xs) == tp.vmem_stream_bytes(2, xs)
                assert jp.hbm_bytes(8, streamed=True) == tp.hbm_bytes(8, streamed=True)
                assert jp.c_tile_options() == tp.c_tile_options()


@pytest.mark.parametrize("model", MODELS)
def test_plan_launch_every_segment(model):
    for jspec, tspec in _segment_specs(model):
        for dt in DTYPES:
            for batch in (1, 8):
                for pref in ("largest", "smallest"):
                    jl = jprog.plan_launch(jspec, batch=batch, compute_dtype=dt,
                                           prefer_region=pref)
                    tl = tprog.plan_launch(tspec, batch=batch, compute_dtype=dt,
                                           prefer_region=pref)
                    if jl is None:
                        assert tl is None
                        continue
                    assert _fields(jl) == _fields(tl)
                    assert jl.describe(batch, 1 << 24) == tl.describe(batch, 1 << 24)
                    assert jl.modeled_us(batch) == tl.modeled_us(batch)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", MODELS)
def test_auto_partition_full_size(model, dtype, batch):
    """The headline plans: all four zoo models at full size."""
    jp = jpart.auto_partition(jgraph.MODELS[model](), batch=batch,
                              compute_dtype=dtype)
    tp = tpart.auto_partition(tgraph.MODELS[model](), batch=batch,
                              compute_dtype=dtype)
    assert _fields(jp) == _fields(tp)
    assert jp.hbm_bytes() == tp.hbm_bytes()
    assert jp.modeled_cycles() == tp.modeled_cycles()
    assert jp.summary() == tp.summary()


def test_resnet18_headline_plans():
    """The slice's plans: ResNet-18 f32 b1 has 12 launches with the last one
    channel-tiled; f32 b8 13 resident launches; VGG-16 f32 b1 a Q=7 alpha=4
    head and a c_tiles=8 tail."""
    b1 = tpart.auto_partition(tgraph.resnet18(), batch=1)
    assert b1.n_launches() == 12
    assert [p.launch.c_tiles for p in b1.pyramids][-1] == 4
    assert sum(p.launch.c_tiles > 1 for p in b1.pyramids) == 1
    b8 = tpart.auto_partition(tgraph.resnet18(), batch=8)
    assert b8.n_launches() == 13
    assert all(p.launch.c_tiles == 1 for p in b8.pyramids)
    vgg = tpart.auto_partition(tgraph.vgg16(), batch=1)
    head, tail = vgg.pyramids[0], vgg.pyramids[-1]
    assert (head.q_convs, head.launch.program.alpha) == (7, 4)
    assert tail.launch.c_tiles == 8


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", MODELS)
def test_layerwise_and_paper_partitions(model, dtype):
    for jf, tf in ((jpart.layerwise_partition, tpart.layerwise_partition),
                   (jpart.paper_partition, tpart.paper_partition)):
        jp = jf(jgraph.MODELS[model](), compute_dtype=dtype)
        tp = tf(tgraph.MODELS[model](), compute_dtype=dtype)
        assert _fields(jp) == _fields(tp)


@pytest.mark.parametrize("model", MODELS)
def test_min_budget_and_replan(model):
    jg, tg = jgraph.MODELS[model](), tgraph.MODELS[model]()
    for dt in DTYPES:
        assert jpart.min_vmem_budget(jg, compute_dtype=dt) == \
            tpart.min_vmem_budget(tg, compute_dtype=dt)
    jplan, tplan = jpart.auto_partition(jg), tpart.auto_partition(tg)
    budget = tpart.min_vmem_budget(tg)
    for jpyr, tpyr in zip(jplan.pyramids, tplan.pyramids):
        jr = jpart.replan_pyramid(jg, jpyr, vmem_budget=budget)
        tr = tpart.replan_pyramid(tg, tpyr, vmem_budget=budget)
        assert [_fields(p) for p in jr] == [_fields(p) for p in tr]


def test_errors_match_the_reference():
    spec_j = _segment_specs("lenet")[0][0]
    spec_t = _segment_specs("lenet")[0][1]
    with pytest.raises(JPlanError):
        jprog.compile_program(spec_j, 3)
    with pytest.raises(PlanError, match="must tile"):
        tprog.compile_program(spec_t, 3)
    with pytest.raises(JBudgetError):
        jpart.auto_partition(jgraph.lenet5(), vmem_budget=1024)
    with pytest.raises(BudgetError, match="fits no launch regime"):
        tpart.auto_partition(tgraph.lenet5(), vmem_budget=1024)


def test_partition_cache_counts_hits():
    tpart.clear_partition_cache()
    g = tgraph.lenet5()
    first = tpart.auto_partition(g, batch=2)
    again = tpart.auto_partition(tgraph.lenet5(), batch=2)
    assert first is again  # Graph is hashable: equal graphs share the entry
    info = tpart.partition_cache_info()
    assert (info.hits, info.misses) == (1, 1)
    tpart.clear_partition_cache()
    assert tpart.partition_cache_info().hits == 0
