"""The port's optimizer (``repro_torch.optim``) against the reference's
(``repro.optim``) on the same numbers, carried across as numpy arrays:

* ``AdamW.update`` over 3 steps on a random tree (float32 and bfloat16
  params), with float32 and bfloat16 moments, the global-norm clip active
  and inactive: float32 params and moments within 1e-6 relative of each
  leaf's max (the same float32 operations; ``pow`` and the norm's sum may
  round differently), bfloat16 values within one bfloat16 step;
* ``warmup_cosine`` at steps 0, 1, 199, 200, 5,000, 10,000 and 20,000:
  equal;
* ``compress_grads`` over 3 error-feedback steps: the int8 blocks, their
  scales, the dequantized gradients and the bfloat16 error equal exactly,
  for sizes on and off the 256-value block;
* the reference's own ``TestAdamW`` and ``TestSchedule`` cases
  (``tests/test_runtime.py``), mirrored.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro.optim.schedule import warmup_cosine as j_warmup_cosine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch.steps import make_optimizer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.params import leaves  # noqa: E402
from repro_torch.optim import grad_compress as gc  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402

SHAPES = {"a": (3, 5), "b": {"c": (7,), "d": (2, 3, 4)}, "e": (300,)}
F32_RTOL = 1e-6


def _tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _tree(v, fn) for k, v in shapes.items()}
    return fn(shapes)


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _to_port(tree):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, tree),
                                        device="cpu")


def _bf16_step(ref):
    """One bfloat16 step (8-bit significand) at each value of ``ref``."""
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _assert_close(got, want, what):
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        a = _np(a)
        bf = np.asarray(b, dtype=np.float32)
        assert a.shape == bf.shape, what
        if b.dtype == jnp.bfloat16:
            assert (np.abs(a - bf) <= _bf16_step(bf)).all(), what
        else:
            err = float(np.abs(a - bf).max())
            assert err <= F32_RTOL * float(np.abs(bf).max()), (what, err)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", ["inactive", "active"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(moments, clip, param_dtype):
    """Three updates with fresh random gradients each (global norm about
    1e-2 with the clip inactive, about 40 with it active), the learning
    rate scaled by the schedule at steps 1, 100 and 400."""
    rng = np.random.default_rng(0)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jparams = _tree(SHAPES, lambda s: jnp.asarray(
        rng.normal(0, 1, s), jdt[param_dtype]))
    params = _to_port(jparams)
    jopt = jadamw.AdamW(moment_dtype=jdt[moments])
    opt = AdamW(moment_dtype=tdt[moments])
    jstate, state = jopt.init(jparams), opt.init(params)
    scale = 1e-3 if clip == "inactive" else 4.0
    for i, sched in enumerate((1, 100, 400)):
        g = _tree(SHAPES, lambda s: rng.normal(0, scale, s).astype(np.float32))
        lr_j = j_warmup_cosine(jnp.int32(sched))
        lr_t = warmup_cosine(torch.tensor(sched, dtype=torch.int32))
        jparams, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                      jparams, lr_j)
        params, state = opt.update(_to_port(g), state, params, lr_t)
        assert int(state.step) == int(jstate.step) == i + 1
        assert state.step.dtype == torch.int32
        _assert_close(params, jparams, ("params", i))
        _assert_close(state.mu, jstate.mu, ("mu", i))
        _assert_close(state.nu, jstate.nu, ("nu", i))
        assert all(m.dtype == tdt[moments] for m in leaves(state.mu))
        assert all(p.dtype == tdt[param_dtype] for p in leaves(params))


def test_adamw_leaves_its_arguments_alone():
    p = {"w": torch.ones(3)}
    opt = AdamW()
    s = opt.init(p)
    new, s2 = opt.update({"w": torch.ones(3)}, s, p)
    assert torch.equal(p["w"], torch.ones(3)) and int(s.step) == 0
    assert int(s2.step) == 1 and not torch.equal(new["w"], p["w"])


def test_make_optimizer_takes_the_config_moments():
    assert make_optimizer(get_config("deepseek_7b")).moment_dtype == \
        torch.float32
    assert make_optimizer(get_config("arctic_480b")).moment_dtype == \
        torch.bfloat16


@pytest.mark.parametrize("step", [0, 1, 199, 200, 5_000, 10_000, 20_000])
def test_warmup_cosine_matches_the_reference(step):
    want = np.float32(j_warmup_cosine(jnp.int32(step)))
    got = warmup_cosine(torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert got.item() == float(want)
    assert warmup_cosine(step).item() == float(want)  # a Python int


@pytest.mark.parametrize("shape", [(512,), (300,), (16, 16), (7, 9)],
                         ids=["2blocks", "ragged", "1block", "tiny"])
def test_compress_grads_matches_the_reference_exactly(shape):
    """Three error-feedback steps: each step's int8 blocks and scales (of
    the gradient plus the carried error), the dequantized gradient and
    the new bfloat16 error, all equal."""
    rng = np.random.default_rng(1)
    jg0 = {"w": jnp.zeros(shape, jnp.float32)}
    jstate = jgc.init_state(jg0)
    state = interop.compress_state_from_numpy(
        jax.tree.map(np.asarray, jstate), device="cpu")
    assert state.error["w"].dtype == torch.bfloat16
    for _ in range(3):
        g = rng.normal(0, 1, shape).astype(np.float32)
        g32 = g + np.asarray(jstate.error["w"], dtype=np.float32)
        jq, js = jgc._quantize(jnp.asarray(g32))
        q, s = gc._quantize(torch.tensor(g32))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        jdeq, jstate = jgc.compress_grads({"w": jnp.asarray(g)}, jstate)
        deq, state = gc.compress_grads({"w": torch.tensor(g)}, state)
        np.testing.assert_array_equal(deq["w"].numpy(), np.asarray(jdeq["w"]))
        np.testing.assert_array_equal(
            state.error["w"].view(torch.int16).numpy(),
            np.asarray(jstate.error["w"]).view(np.int16))


def test_round_half_to_even_in_both():
    """Values at exact halves of a scale step: both packages round them to
    the even integer (jnp.round and torch.round)."""
    g = np.zeros(256, np.float32)
    g[0] = 127.0  # scale = 1 (+1e-12)
    g[1:6] = [0.5, 1.5, 2.5, -0.5, -2.5]
    q, _ = gc._quantize(torch.tensor(g))
    jq, _ = jgc._quantize(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q[0, 1:6].tolist() == [0, 2, 2, 0, -2]


# ---- the reference's TestAdamW and TestSchedule, mirrored ----------------


def test_descends_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 0.1


def test_moment_dtype():
    opt = AdamW(moment_dtype=torch.bfloat16)
    params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state.mu["w"].dtype == torch.bfloat16
    params2, state2 = opt.update({"w": torch.ones(4)}, state, params)
    assert state2.mu["w"].dtype == torch.bfloat16
    assert params2["w"].dtype == torch.bfloat16


def test_grad_clip():
    opt = AdamW(lr=1e-3, grad_clip=1.0)
    params = {"w": torch.zeros((2,))}
    state = opt.init(params)
    p1, _ = opt.update({"w": torch.tensor([1e6, 0.0])}, state, params)
    assert bool(torch.isfinite(p1["w"]).all())


def test_warmup_then_decay():
    lrs = [float(warmup_cosine(torch.tensor(s, dtype=torch.int32), warmup=10,
                               total=100)) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0  # warmup ascends
    assert lrs[99] < lrs[50] < lrs[11]  # cosine descends
    assert lrs[99] >= 0.1 - 1e-6  # floor


def test_error_feedback_preserves_sum():
    rng = np.random.default_rng(0)
    params = {"w": torch.zeros((512,))}
    state = gc.init_state(params)
    true_sum = np.zeros(512)
    deq_sum = np.zeros(512)
    for _ in range(30):
        g = {"w": torch.tensor(rng.normal(0, 1, 512), dtype=torch.float32)}
        true_sum += g["w"].numpy()
        deq, state = gc.compress_grads(g, state)
        deq_sum += deq["w"].numpy()
    err = np.abs(true_sum - deq_sum).max()
    assert err < 0.05 * np.abs(true_sum).max() + 0.1


def test_quantization_bounded_error_per_step():
    g = {"w": torch.tensor(np.linspace(-3, 3, 1024), dtype=torch.float32)}
    deq, _ = gc.compress_grads(g, gc.init_state(g))
    assert float((deq["w"] - g["w"]).abs().max()) <= 3.0 / 127 + 1e-5
