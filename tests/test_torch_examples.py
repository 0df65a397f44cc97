"""The port's four examples (``examples/torch_*.py``) on the CPU, at small
sizes, against the reference's own functions and examples.

* quickstart: the plan, the DS-1 design point and the END figures equal
  the reference's on the reference's own input and weights, carried across;
* fused CNN inference: its plans under the reference's budget equal the
  reference's field by field, and its dense and sparse forwards hold to the
  reference's ``reference_network`` with the skip maps its intermediates
  give;
* serve_lm: three rates;
* train_lm: the ~100M config equals the reference's, and a cut of it
  trains, checkpoints and resumes.
"""

import dataclasses
import importlib.util
import os
import pathlib
import re
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import (  # noqa: E402
    end_statistics as j_end_statistics,
    evaluate_design as j_evaluate_design,
    init_pyramid_params as j_init_pyramid_params,
    plan_fusion as j_plan_fusion,
    to_digits as j_to_digits,
)
from repro.core.cnn_models import LENET5_FUSION as J_LENET5  # noqa: E402
from repro.core.cnn_models import PAPER_OPS as J_PAPER_OPS  # noqa: E402
from repro.core.executor import conv_windows as j_conv_windows  # noqa: E402
from repro.net import graph as jgraph  # noqa: E402
from repro.net import partition as jpart  # noqa: E402
from repro.net import runner as jrunner  # noqa: E402
from repro_torch.core.program import REFERENCE_BUDGET  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    params_from_numpy,
    pyramid_params_from_numpy,
)
from repro_torch.net import runner as trunner  # noqa: E402
from test_pyramid_kernel import _expected_skip_maps  # noqa: E402
from test_torch_plans import _fields, _plan_fields  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _example(name: str):
    """Import ``examples/torch_<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


quickstart = _example("quickstart")
fused = _example("fused_cnn_inference")
serve_lm = _example("serve_lm")
train_lm = _example("train_lm")


# ---- quickstart ------------------------------------------------------------


def _reference_end_values():
    """The reference quickstart's input, weights and CL1 values (its step
    4, ``examples/quickstart.py``)."""
    params = j_init_pyramid_params(J_LENET5, jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 32, 32, 1))
    win, _ = j_conv_windows(x, J_LENET5, level=0, max_windows=256)
    vals = win[0] @ params.weights[0].reshape(-1, 6)[:, 0]
    return params, x, vals


def test_quickstart_plan_and_design_equal_the_reference():
    from repro_torch.core import evaluate_design, plan_fusion
    from repro_torch.core.cnn_models import LENET5_FUSION, PAPER_OPS

    tp = plan_fusion(LENET5_FUSION, out_region=1)
    jp = j_plan_fusion(J_LENET5, out_region=1)
    assert tp.alpha == jp.alpha == 5
    assert [(l.tile, l.stride) for l in tp.levels] == [
        (l.tile, l.stride) for l in jp.levels]
    td = evaluate_design("ds1", LENET5_FUSION, tp, PAPER_OPS[("lenet", "Fused")])
    jd = j_evaluate_design("ds1", J_LENET5, jp, J_PAPER_OPS[("lenet", "Fused")])
    assert (td.duration_us, td.gops, td.cycles) == (
        jd.duration_us, jd.gops, jd.cycles)
    assert td.duration_us == 13.75 and f"{td.gops:.2f}" == "86.10"


def test_quickstart_end_figures_equal_the_reference_on_its_inputs():
    jparams, jx, jvals = _reference_end_values()
    vn = jnp.clip(jvals / (4 * jnp.std(jvals)), -0.999, 0.999)
    ref = j_end_statistics(j_to_digits(vn, 16), vn)

    params = pyramid_params_from_numpy(jparams, device="cpu")
    x = torch.from_numpy(np.array(jx))
    vals = quickstart.window_values(x, params)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=1e-5)
    st = quickstart.end_figures(vals)
    assert st.detected_frac == ref.detected_frac
    assert st.cycle_savings == ref.cycle_savings
    assert dataclasses.asdict(st) == dataclasses.asdict(ref)
    assert f"{100 * st.detected_frac:.2f}" == "51.56"
    assert quickstart.fused_error(x, params) <= 1e-5


def test_quickstart_default_std_would_differ():
    """``torch.std`` defaults to Bessel's correction, ``jnp.std`` to none:
    with the default the scaled values, and so the END figures, move."""
    from repro_torch.core import end_statistics, to_digits

    jparams, jx, jvals = _reference_end_values()
    vn = jnp.clip(jvals / (4 * jnp.std(jvals)), -0.999, 0.999)
    ref = j_end_statistics(j_to_digits(vn, 16), vn)
    vals = quickstart.window_values(
        torch.from_numpy(np.array(jx)),
        pyramid_params_from_numpy(jparams, device="cpu"))
    bessel = torch.clamp(vals / (4 * torch.std(vals)), -0.999, 0.999)
    st = end_statistics(to_digits(bessel, 16), bessel)
    assert st.cycle_savings != ref.cycle_savings


def test_quickstart_main_prints_the_reference_lines(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "uniform alpha: 5  (paper: 5)" in out
    assert "fused vs reference max err: 0.0 (cpu)" in out
    assert "DS-1 fused duration: 13.75 us" in out
    assert "86.10 GOPS (paper: 86.10)" in out
    assert "FPGA cycle model" in out
    assert re.search(r"END: [\d.]+% detected negative early, [\d.]+% digit"
                     r" cycles saved", out)


# ---- fused CNN inference ---------------------------------------------------

FUSED_MODELS = ("lenet", "resnet18")
FUSED_SIZE = 32
FUSED_BATCH = 2


def _reference_values(x, graph, params):
    """Every node's value of the reference's ``reference_network``."""
    values = {graph.nodes[0].name: x.astype(jnp.float32)}
    for n in graph.nodes[1:]:
        if n.op == "conv":
            w, b = params[n.name]
            values[n.name] = jrunner._conv_node(values[n.inputs[0]], n, w, b)
        elif n.op == "pool":
            values[n.name] = jrunner._pool_node(values[n.inputs[0]], n)
        else:
            values[n.name] = jrunner._head_op(values, n, params, graph)
    return values


def _expected_skips(jplan, x, params):
    """Each launch's skip map from the reference's intermediates."""
    graph = jplan.graph
    values = _reference_values(x, graph, params)
    out = {}
    for pyr in jplan.pyramids:
        x_in = values[graph.node(pyr.node_names[0]).inputs[0]]
        convs = [m for m in pyr.node_names if graph.node(m).op == "conv"]
        ws = [params[m][0] for m in convs]
        bs = [params[m][1] for m in convs]
        out[pyr.name] = np.stack([
            _expected_skip_maps(pyr.spec, ws, bs, x_in[b:b + 1],
                                pyr.launch.out_region)[0]
            for b in range(x.shape[0])
        ])
    return out


@pytest.mark.parametrize("model", FUSED_MODELS)
def test_fused_plans_equal_the_reference(model):
    tg = fused.MODELS[model](input_size=FUSED_SIZE, num_classes=10)
    jg = jgraph.MODELS[model](input_size=FUSED_SIZE, num_classes=10)
    ours = fused.make_plans(tg, FUSED_BATCH, REFERENCE_BUDGET)
    theirs = (jpart.auto_partition(jg, batch=FUSED_BATCH),
              jpart.layerwise_partition(jg, batch=FUSED_BATCH),
              jpart.auto_partition(jg, batch=FUSED_BATCH,
                                   prefer_region="smallest"))
    for tp, jp in zip(ours, theirs):
        assert _fields(jp) == _plan_fields(tp)


@pytest.mark.parametrize("model", FUSED_MODELS)
def test_fused_forwards_hold_to_the_reference(model):
    """The example's dense and sparse inputs, the reference's params
    carried across: logits within 1e-4 of ``reference_network`` and skip
    maps equal to those the reference's intermediates give."""
    tg = fused.MODELS[model](input_size=FUSED_SIZE, num_classes=10)
    jg = jgraph.MODELS[model](input_size=FUSED_SIZE, num_classes=10)
    jp = jrunner.init_network_params(jg, jax.random.PRNGKey(0))
    jnp_params = {k: (np.asarray(w), np.asarray(b)) for k, (w, b) in jp.items()}
    params = params_from_numpy(jnp_params, device="cpu")
    _, x = fused.make_inputs(tg, FUSED_BATCH, "cpu")
    sparse_params, xs = fused.sparse_inputs(tg, params, x)
    jsparse = {k: (w.numpy(), b.numpy()) for k, (w, b) in sparse_params.items()}
    plan, _, tight = fused.make_plans(tg, FUSED_BATCH, REFERENCE_BUDGET)
    jtight = jpart.auto_partition(jg, batch=FUSED_BATCH,
                                  prefer_region="smallest")
    for inp, ps, jps, p in ((x, params, jnp_params, plan),
                            (xs, sparse_params, jsparse, tight)):
        logits, skips = trunner.run_network(
            inp, trunner.prepare_network_params(p, ps), plan=p)
        ref = np.array(jrunner.reference_network(jnp.asarray(inp.numpy()),
                                                 jg, jps))
        np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4)
        assert fused.logit_limit(torch.from_numpy(ref), "float32") >= float(
            np.abs(logits.numpy() - ref).max())
    expected = _expected_skips(jtight, jnp.asarray(xs.numpy()), jsparse)
    assert list(skips) == list(expected)
    for name, want in expected.items():
        np.testing.assert_array_equal(skips[name].numpy(), want)
    fired, cells = fused.skip_cells(skips)
    assert fired == sum(int(m[..., 1:].sum()) for m in expected.values())
    if model == "lenet":  # its one Q = 2 launch tiles the map 5 x 5
        assert 0 < fired < cells


def test_fused_main_on_the_cpu(capsys):
    assert fused.main(["--model", "lenet", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "input 32x32" in out and "device cpu" in out
    assert "plan (card budget): 1 launches: CL1..MPL2 Q=2" in out
    err, limit = map(float, re.search(
        r"reference: (\S+) \(limit (\S+), float32\)", out).groups())
    assert err <= limit
    assert "END skips CL1..MPL2" in out
    assert re.search(r"END skipped cells: [1-9]\d* of 50", out)
    assert "python -m repro_torch.obs.explain --model lenet" in out


# ---- serve_lm ---------------------------------------------------------------


def test_serve_lm_main_on_the_cpu(capsys):
    assert serve_lm.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(serve_lm.ARCHS)
    for arch, line in zip(serve_lm.ARCHS, lines):
        m = re.match(rf"{arch}\s+generated (\d+) tokens/seq at ([\d.]+) tok/s"
                     r" \(reduced config, cpu\)", line)
        assert m, line
        assert int(m.group(1)) == 12 and float(m.group(2)) > 0


# ---- train_lm ---------------------------------------------------------------


def test_lm100m_config_equals_the_reference():
    import repro.configs.deepseek_7b as jds

    ref = dataclasses.replace(
        jds.CONFIG,
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_head=64,
        d_ff=2048, vocab=32000, remat="none",
    )
    assert dataclasses.asdict(train_lm.lm100m_config()) == dataclasses.asdict(ref)
    assert train_lm.lm100m_config(n_layers=2).n_layers == 2


def test_train_lm_trains_and_resumes(tmp_path, capsys):
    """A cut of the config through the example's own loop: 51 steps save a
    checkpoint at step 50, and a run to 52 resumes after it."""
    cut = train_lm.lm100m_config(n_layers=2, d_model=64, n_heads=4,
                                 n_kv_heads=4, d_head=16, d_ff=128, vocab=512)
    argv = ["--seq-len", "16", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    losses = train_lm.train_lm(["--steps", "51", *argv], config=cut)
    assert len(losses) == 51 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    capsys.readouterr()
    assert train_lm.main(["--steps", "52", *argv], config=cut) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 50" in out
    assert "step    51 loss" in out
    assert "ran 1 step after the checkpoint" in out
    # a run that asks for no step past the checkpoint trains none and fails
    assert train_lm.main(["--steps", "51", *argv], config=cut) == 1
    assert "ran 0 steps" in capsys.readouterr().out


def test_train_lm_default_checkpoints_are_its_own():
    """Not the reference example's directory, which a run would resume
    from, and under the temporary directory, so it follows ``$TMPDIR``."""
    assert train_lm.DEFAULT_CKPT_DIR == os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt")
