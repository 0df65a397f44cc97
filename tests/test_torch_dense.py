"""The port's dense decoder family (pre-norm GQA attention with RoPE +
SwiGLU: DeepSeek-7B, GLM-4-9B, Phi-4-mini-3.8B) on CPU tensors against the
reference's, at each config's reduced size in float32
(``dataclasses.replace(cfg.reduced(), dtype="float32")``: 2 layers, 4 query
heads over 2 KV heads, attention chunk 16).

The reference's params carried across by ``lm_params_from_numpy`` (bit for
bit); the ``make_prefill_step`` logits at S = 32 (chunked attention) and
the ``forward`` logits at S = 40 within 5e-4 max(1, max|logit|); each of
24 ``decode_step``s within atol 2e-4 (``tests/test_torch_lm.py``'s bounds),
the KV caches after them too; ``dense_layer`` alone; the specs,
``param_count`` and caches field by field; ``serve`` on the CPU.  The
reference's steps run under ``jax.jit``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.steps import make_prefill_step as j_prefill  # noqa: E402
from repro.models import blocks as jB  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models import serving as jS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import serving as S  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402

ARCHS = ("deepseek_7b", "glm4_9b", "phi4_mini_3_8b")
T = 40
PREFILL = 32  # a multiple of the reduced attention chunk of 16
STEPS = 24


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(j_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jit_init(jcfg):
    return jax.jit(lambda k: jM.init_params(jcfg, k))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """One reduced f32 config in both packages, the reference's params, the
    same params in the port, and (2, T) tokens."""
    jcfg, cfg = _cfgs(request.param)
    jparams = _jit_init(jcfg)(jax.random.PRNGKey(0))
    params = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, T))
    return jcfg, cfg, jparams, params, tokens


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _logit_bound(want):
    return 5e-4 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_the_reference(arch):
    for full in (True, False):
        j, t = j_get_config(arch), get_config(arch)
        if not full:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.family == "dense" and t.source


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_specs_match_the_reference(arch, full):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    if not full:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert cfg.param_count() == jcfg.param_count()
    specs = _flat(M.build_param_specs(cfg))
    jspecs = _flat(jM.build_param_specs(jcfg))
    assert set(specs) == set(jspecs)
    for k, s in specs.items():
        assert (s.shape, s.axes, s.scale) == (jspecs[k].shape, jspecs[k].axes,
                                             jspecs[k].scale), k


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_match_the_reference(arch):
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs(arch, dtype)
        specs = S.build_cache_specs(cfg, 3, 24)
        jspecs = jS.build_cache_specs(jcfg, 3, 24)
        assert set(specs) == set(jspecs) == {"k", "v"}
        for k, s in specs.items():
            assert (s.shape, s.axes, s.scale) == (
                jspecs[k].shape, jspecs[k].axes, jspecs[k].scale), k
        got = S.init_caches(cfg, 3, 24, device="cpu")
        want = jS.init_caches(jcfg, 3, 24)
        for k, t in got.items():
            assert tuple(t.shape) == want[k].shape, k
            assert t.dtype == getattr(torch, dtype) and not t.any(), k


def test_params_carry_across_exactly(pair):
    jcfg, _, jparams, params, _ = pair
    got, want = _flat(params), _flat(jax.tree.map(np.asarray, jparams))
    assert set(got) == set(want)
    for k, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)


def test_prefill_logits_match_the_reference(pair):
    jcfg, cfg, jparams, params, tokens = pair
    toks = tokens[:, :PREFILL]
    want = np.asarray(jax.jit(j_prefill(jcfg))(
        jparams, {"tokens": jnp.asarray(toks)}))
    got = make_prefill_step(cfg)(params, {"tokens": torch.tensor(toks)})
    assert tuple(got.shape) == (2, cfg.vocab)
    assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want)


def test_forward_logits_match_the_reference(pair):
    jcfg, cfg, jparams, params, tokens = pair
    want = np.asarray(jax.jit(lambda p, t: jM.forward(jcfg, p, t)[0])(
        jparams, jnp.asarray(tokens)))
    got, caches = M.forward(cfg, params, torch.tensor(tokens))
    assert caches is None
    assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want)
    # the port's chunked attention against its dense over 32 positions
    chunked, _ = M.forward(cfg, params, torch.tensor(tokens[:, :PREFILL]),
                           chunked=True)
    err = float((chunked - got[:, :PREFILL]).abs().max())
    assert err <= _logit_bound(want)


def test_decode_steps_match_the_reference(pair):
    jcfg, cfg, jparams, params, tokens = pair
    jcaches = jS.init_caches(jcfg, 2, STEPS)
    caches = S.init_caches(cfg, 2, STEPS, device="cpu")
    jstep = jax.jit(lambda p, t, c, i: jS.decode_step(jcfg, p, t, c, i))
    step = make_decode_step(cfg)
    for t in range(STEPS):
        want, jcaches = jstep(jparams, jnp.asarray(tokens[:, t:t + 1]),
                              jcaches, jnp.int32(t))
        got, out = step(params, torch.tensor(tokens[:, t:t + 1]), caches, t)
        assert out is caches
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                                   err_msg=f"step {t}")
    for k in ("k", "v"):
        np.testing.assert_allclose(caches[k].numpy(), np.asarray(jcaches[k]),
                                   atol=2e-4, err_msg=k)


def test_dense_layer_matches_the_reference(pair):
    jcfg, cfg, jparams, params, _ = pair
    x = np.random.default_rng(5).normal(0, 1, (2, 32, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree.map(lambda t: t[1], jparams["layers"])
    p = tree_map(lambda t: t[1], params["layers"])
    for chunked in (False, True):
        jctx = jB.LayerCtx(mode="prefill", chunked=chunked)
        want, _, _ = jax.jit(lambda p, x: jB.dense_layer(jcfg, p, x, jctx))(
            jp, jnp.asarray(x))
        got, cache, aux = B.dense_layer(
            cfg, p, torch.tensor(x), B.LayerCtx(mode="prefill", chunked=chunked))
        assert cache is None and aux == 0.0
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= 2e-5 * max(
            1.0, float(np.abs(want).max()))


def test_prefill_needs_a_chunk_multiple(pair):
    _, cfg, _, params, tokens = pair
    with pytest.raises(ValueError, match="multiple of"):
        make_prefill_step(cfg)(params, {"tokens": torch.tensor(tokens[:, :20])})


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_returns_valid_tokens(arch):
    gen, tps = serve(arch, batch=2, prompt_len=4, new_tokens=5, reduced=True,
                     device="cpu")
    cfg = get_config(arch).reduced()
    assert tuple(gen.shape) == (2, 5) and tps > 0
    assert int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab
