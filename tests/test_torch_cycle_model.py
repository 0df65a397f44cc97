"""The port's paper arithmetic against the reference's, for every spec in
``NETWORKS`` and ``resnet18_fusions()``: ``cnn_models`` (specs, op counts,
region pins), the DS-1/DS-2 and baseline cycle models, Eq. (2)'s
``evaluate_design`` / ``single_layer_result`` and the intensity model, all
exactly equal."""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core import cnn_models as jcm  # noqa: E402
from repro.core import cycle_model as jcyc  # noqa: E402
from repro.core import intensity as jint  # noqa: E402
from repro.core.fusion import plan_fusion as j_plan_fusion  # noqa: E402
from repro.core.program import compile_program as j_compile  # noqa: E402
from repro_torch.core import cnn_models as tcm  # noqa: E402
from repro_torch.core import cycle_model as tcyc  # noqa: E402
from repro_torch.core import intensity as tint  # noqa: E402
from repro_torch.core.fusion import plan_fusion  # noqa: E402
from repro_torch.core.program import compile_program  # noqa: E402

# (name, port spec, reference spec, out_region for plan_fusion)
SPECS = {
    **{
        net: (tcm.NETWORKS[net], jcm.NETWORKS[net], tcm.PAPER_OUT_REGION[net])
        for net in sorted(tcm.NETWORKS)
    },
    **{
        f"resnet18_blk{i}": (t, j, None)
        for i, (t, j) in enumerate(zip(tcm.resnet18_fusions(),
                                       jcm.resnet18_fusions()))
    },
}
DESIGNS = sorted(tcyc._PER_MOVEMENT)


def _asdict(x):
    return dataclasses.asdict(x)


def _case(name):
    spec, jspec, region = SPECS[name]
    return (spec, plan_fusion(spec, out_region=region), jspec,
            j_plan_fusion(jspec, out_region=region))


def test_cnn_models_equal():
    assert sorted(tcm.NETWORKS) == sorted(jcm.NETWORKS)
    assert tcm.PAPER_OPS == jcm.PAPER_OPS
    assert tcm.PAPER_OUT_REGION == jcm.PAPER_OUT_REGION
    for a in ("LENET5_INPUT", "ALEXNET_INPUT", "VGG_INPUT"):
        assert getattr(tcm, a) == getattr(jcm, a)
    for a in ("LENET5_FUSION", "ALEXNET_FUSION", "VGG_FUSION"):
        assert _asdict(getattr(tcm, a)) == _asdict(getattr(jcm, a))
    assert len(tcm.resnet18_fusions(32)) == len(jcm.resnet18_fusions(32)) == 8
    for t, j in zip(tcm.resnet18_fusions(32), jcm.resnet18_fusions(32)):
        assert _asdict(t) == _asdict(j)
    assert _asdict(tcm.resnet18_block_fusion(64, 128, 56, 2)) == _asdict(
        jcm.resnet18_block_fusion(64, 128, 56, 2))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_cycles_per_movement_equal(name):
    spec, _, jspec, _ = _case(name)
    for fn in ("ds1_cycles_per_movement", "ds2_cycles_per_movement",
               "conv_baseline_spatial_cycles_per_movement",
               "conv_baseline_temporal_cycles_per_movement"):
        for pool in (True, False):
            assert getattr(tcyc, fn)(spec, include_pool=pool) == getattr(
                jcyc, fn)(jspec, include_pool=pool), (fn, pool)
    assert tcyc.ds1_split_cycles_per_movement(spec) == \
        jcyc.ds1_split_cycles_per_movement(jspec)
    p = tcyc.ArithParams(n=16, acc=2, mp_cycles=3)
    jp = jcyc.ArithParams(n=16, acc=2, mp_cycles=3)
    assert tcyc.ds2_cycles_per_movement(spec, p) == \
        jcyc.ds2_cycles_per_movement(jspec, jp)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_designs_equal(name):
    spec, plan, jspec, jplan = _case(name)
    assert tcyc.naive_alpha(plan) == jcyc.naive_alpha(jplan)
    ops = sum(tcm.conv_ops(l, n) for l, n in zip(
        spec.levels, spec.feature_sizes()[1:]) if l.kind == "conv")
    assert ops == sum(jcm.conv_ops(l, n) for l, n in zip(
        jspec.levels, jspec.feature_sizes()[1:]) if l.kind == "conv")
    for design in DESIGNS:
        for uniform in (True, False):
            got = tcyc.evaluate_design(design, spec, plan, ops,
                                       uniform_stride=uniform)
            want = jcyc.evaluate_design(design, jspec, jplan, ops,
                                        uniform_stride=uniform)
            assert _asdict(got) == _asdict(want), (design, uniform)
        for ci in range(spec.q_convs):
            assert _asdict(tcyc.single_layer_result(
                design, spec, plan, ci, ops)) == _asdict(
                jcyc.single_layer_result(design, jspec, jplan, ci, ops))


@pytest.mark.parametrize("net,paper_us", [("lenet", 13.75),
                                          ("alexnet", 63.99), ("vgg", 11.79)])
def test_ds1_reproduces_table1(net, paper_us):
    """Eq. (3) gives the paper's Table 1 fused durations exactly."""
    spec, plan, _, _ = _case(net)
    res = tcyc.evaluate_design("ds1", spec, plan,
                               tcm.PAPER_OPS[(net, "Fused")])
    assert res.duration_us == pytest.approx(paper_us, abs=1e-9)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_intensity_equal(name):
    spec, plan, jspec, jplan = _case(name)
    for bpv in (1, 2, 4):
        assert tint.weight_bytes(spec, bpv) == jint.weight_bytes(jspec, bpv)
        assert tint.unfused_bytes(spec, bpv) == jint.unfused_bytes(jspec, bpv)
        for uniform in (True, False):
            assert tint.fused_bytes(spec, plan, uniform=uniform,
                                    bytes_per_val=bpv) == jint.fused_bytes(
                jspec, jplan, uniform=uniform, bytes_per_val=bpv)
    assert tint.intensity_improvement(spec, plan) == \
        jint.intensity_improvement(jspec, jplan)
    pt = tint.IntensityPoint("ds1", 1000, 250, 2.5)
    jpt = jint.IntensityPoint("ds1", 1000, 250, 2.5)
    assert (pt.intensity, pt.gops) == (jpt.intensity, jpt.gops)


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("name", ["lenet", "vgg", "resnet18_blk2"])
def test_launch_dataflow_equal(name, streamed):
    spec, _, jspec, _ = _case(name)
    for dtype in ("float32", "bfloat16"):
        prog = compile_program(spec, 1, compute_dtype=dtype)
        jprog = j_compile(jspec, 1, compute_dtype=dtype)
        for batch in (1, 8):
            flow = tint.launch_dataflow(prog, batch, streamed=streamed)
            assert flow == jint.launch_dataflow(jprog, batch,
                                                streamed=streamed)
            assert sum(v for k, v in flow.items()
                       if k != "input_bytes_whole_image") == prog.hbm_bytes(
                batch, streamed=streamed)
