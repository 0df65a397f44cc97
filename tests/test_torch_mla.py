"""The port's multi-head latent attention (MLA) and the MiniCPM3-4B dense
decoder that runs it, on CPU tensors against the reference's, at the
reduced config in float32 (``dataclasses.replace(cfg.reduced(),
dtype="float32")``: 2 layers, 4 heads, q_lora 32, kv_lora 16, d_nope 8,
d_rope 8, d_v 16, attention chunk 16).

Within 1e-5 max(1, max|out|) (the layer): ``mla_attention`` dense, chunked
(also with ``d_v = 12`` against ``d_nope + d_rope = 24``: the chunked
path's value width differs from its key width) and step by step through
a cache, whose ``ckv`` and ``krope`` must equal the reference's within
1e-5 after every step and be written in place.  Within 1e-4 max(1,
max|logit|) (logits): the ``make_prefill_step`` logits at S = 32, the
``forward`` logits at S = 40, the chunked forward at S = 40 (chunk 8)
against the dense one, each of 24 ``decode_step``s against the
reference's (the latent caches within 1e-5 after every step), and the
port's decode against its own forward.  Exact: the specs, ``param_count``,
the cache specs, the params and caches carried across by
``lm_params_from_numpy`` (bit for bit, float32 and bfloat16).  ``serve``
and its CLI on the CPU.  The reference's steps run under ``jax.jit``.
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
from repro.models import layers as jL  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models import serving as jS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import serving as S  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402

ARCH = "minicpm3_4b"
T = 40
PREFILL = 32  # a multiple of the reduced attention chunk of 16
STEPS = 24
LAYER_TOL = 1e-5


def _cfgs(dtype="float32", **change):
    return (dataclasses.replace(j_get_config(ARCH).reduced(), dtype=dtype,
                                **change),
            dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype,
                                **change))


@functools.lru_cache(maxsize=None)
def _jit_init(jcfg):
    return jax.jit(lambda k: jM.init_params(jcfg, k))


def _params(jcfg, seed=0):
    jparams = _jit_init(jcfg)(jax.random.PRNGKey(seed))
    return jparams, interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def pair():
    """The reduced f32 config in both packages, the reference's params, the
    same params in the port, and (2, T) tokens."""
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, T))
    return jcfg, cfg, jparams, params, tokens


@pytest.fixture(scope="module")
def forwards(pair):
    """The reference's and the port's forward logits over all T tokens."""
    jcfg, cfg, jparams, params, tokens = pair
    want = jax.jit(lambda p, t: jM.forward(jcfg, p, t)[0])(
        jparams, jnp.asarray(tokens))
    got, caches = M.forward(cfg, params, torch.tensor(tokens))
    assert caches is None
    return np.asarray(want), got


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _logit_bound(want):
    return 1e-4 * max(1.0, float(np.abs(want).max()))


def _assert_layer_close(got, want, what=""):
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= LAYER_TOL * max(1.0, float(np.abs(want).max())), (what, err)


def _mla_kw(cfg):
    """The port's ``mla_attention`` arguments and the reference's, which
    also takes the two lora widths."""
    kw = dict(n_heads=cfg.n_heads, d_nope=cfg.d_nope, d_rope=cfg.d_rope,
              d_v=cfg.d_v, rope_theta=cfg.rope_theta)
    return kw, dict(kw, q_lora=cfg.q_lora_rank, kv_lora=cfg.kv_lora_rank)


# ---------------------------------------------------------------------------
# configs, specs and caches
# ---------------------------------------------------------------------------


def test_config_matches_the_reference():
    for full in (True, False):
        j, t = j_get_config(ARCH), get_config(ARCH)
        if not full:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    cfg = get_config("minicpm3-4b")
    assert (cfg.family, cfg.attn_kind, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.q_lora_rank, cfg.kv_lora_rank, cfg.d_nope, cfg.d_rope,
            cfg.d_v, cfg.d_ff, cfg.vocab) == (
        "dense", "mla", 62, 2560, 40, 768, 256, 64, 32, 64, 6400, 73448)
    assert cfg.source == "hf:openbmb/MiniCPM3-4B"


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_param_count_and_specs_match_the_reference(full):
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    if not full:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == cfg.param_count()  # no experts
    specs = _flat(M.build_param_specs(cfg))
    jspecs = _flat(jM.build_param_specs(jcfg))
    assert set(specs) == set(jspecs)
    for k, s in specs.items():
        assert (s.shape, s.axes, s.scale) == (jspecs[k].shape, jspecs[k].axes,
                                             jspecs[k].scale), k
    if full:
        assert 4.26e9 < cfg.param_count() < 4.27e9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_specs_and_caches_match_the_reference(dtype):
    jcfg, cfg = _cfgs(dtype)
    specs = S.build_cache_specs(cfg, 3, 24)
    jspecs = jS.build_cache_specs(jcfg, 3, 24)
    assert set(specs) == set(jspecs) == {"ckv", "krope"}
    for k, s in specs.items():
        assert (s.shape, s.axes, s.scale) == (jspecs[k].shape, jspecs[k].axes,
                                             jspecs[k].scale), k
    got = S.init_caches(cfg, 3, 24, device="cpu")
    want = jS.init_caches(jcfg, 3, 24)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
        assert t.dtype == getattr(torch, dtype) and not t.any(), k


def test_full_cache_bytes_a_token():
    """(256 + 32) x 2 B x 62 layers = 35,712 B a token at bf16, where a
    GQA cache of the same 40 heads (K 96 + V 64 wide) would take
    793,600 B."""
    specs = _flat(S.build_cache_specs(get_config(ARCH), 1, 1))
    per_token = sum(int(np.prod(s.shape)) for s in specs.values()) * 2
    assert per_token == 35_712


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_and_caches_carry_across_exactly(dtype):
    jcfg, _ = _cfgs(dtype)
    jparams = _jit_init(jcfg)(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    jcaches = jax.tree.map(  # the reference's caches, filled with noise
        lambda c: jnp.asarray(rng.normal(0, 1, c.shape), c.dtype),
        jS.init_caches(jcfg, 2, 16))
    for tree in (jparams, jcaches):
        want = jax.tree.map(np.asarray, tree)
        got = interop.lm_params_from_numpy(want, device="cpu")
        got, want = _flat(got), _flat(want)
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.dtype == getattr(torch, dtype), k
            w = want[k]
            if dtype == "bfloat16":
                t, w = t.view(torch.int16), w.view(np.int16)  # bit patterns
            np.testing.assert_array_equal(t.numpy(), w, err_msg=k)


# ---------------------------------------------------------------------------
# the attention layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunked", [False, True], ids=["dense", "chunked"])
@pytest.mark.parametrize("change", [{}, dict(d_nope=16, d_v=12)],
                         ids=["reduced", "dv12-dk24"])
def test_mla_attention_matches_the_reference(chunked, change):
    jcfg, cfg = _cfgs(**change)
    jparams, params = _params(jcfg, 2)
    jp = jax.tree.map(lambda t: t[0], jparams["layers"]["attn"])
    p = tree_map(lambda t: t[0], params["layers"]["attn"])
    x = np.random.default_rng(5).normal(0, 1, (2, 32, cfg.d_model)).astype(
        np.float32)
    kw, jkw = _mla_kw(cfg)
    want, jcache = jax.jit(lambda p, x: jL.mla_attention(
        p, x, chunked=chunked, q_chunk=16, kv_chunk=16, **jkw))(
        jp, jnp.asarray(x))
    got, cache = L.mla_attention(p, torch.tensor(x), chunked=chunked,
                                 q_chunk=16, kv_chunk=16, **kw)
    assert cache is None and jcache is None
    assert tuple(got.shape) == (2, 32, cfg.d_model)
    _assert_layer_close(got, want)


def test_chunked_attention_takes_a_narrower_value():
    """``chunked_attention`` with d_v = 12 against d = 24 keys equals
    ``dense_attention`` on the same inputs."""
    rng = np.random.default_rng(8)
    q, k = (torch.tensor(rng.normal(0, 1, (2, 32, 4, 24)), dtype=torch.float32)
            for _ in range(2))
    v = torch.tensor(rng.normal(0, 1, (2, 32, 4, 12)), dtype=torch.float32)
    got = L.chunked_attention(q, k, v, causal=True, q_chunk=8, kv_chunk=8)
    want = L.dense_attention(q, k, v, causal=True)
    assert tuple(got.shape) == (2, 32, 4, 12)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_mla_attention_with_a_cache_matches_the_reference():
    """Token by token through the latent cache: each step's output, and
    ``ckv`` / ``krope`` after each step, as the reference's; the writes
    land in place at ``cache_index`` and nowhere else."""
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg, 2)
    jp = jax.tree.map(lambda t: t[0], jparams["layers"]["attn"])
    p = tree_map(lambda t: t[0], params["layers"]["attn"])
    x = np.random.default_rng(6).normal(0, 1, (2, 12, cfg.d_model)).astype(
        np.float32)
    kw, jkw = _mla_kw(cfg)
    full = tree_map(lambda t: t[0], S.init_caches(cfg, 2, 12, device="cpu"))
    jcache = jax.tree.map(lambda t: t[0], jS.init_caches(jcfg, 2, 12))
    ckv, krope = full["ckv"], full["krope"]
    jstep = jax.jit(lambda p, x, c, i: jL.mla_attention(
        p, x, kv_cache=c, cache_index=i, **jkw))
    for t in range(12):
        want, jcache = jstep(jp, jnp.asarray(x[:, t:t + 1]), jcache,
                             jnp.int32(t))
        got, cache = L.mla_attention(p, torch.tensor(x[:, t:t + 1]),
                                     kv_cache=full, cache_index=t, **kw)
        assert cache["ckv"] is ckv and cache["krope"] is krope
        _assert_layer_close(got, want, f"step {t}")
        for k in ("ckv", "krope"):
            _assert_layer_close(full[k], jcache[k], f"{k} after step {t}")
        assert not ckv[:, t + 1:].any() and bool(ckv[:, t].any())


def _mla_steps(n, seed):
    """A reduced MLA layer's params in both packages and its latent
    caches of ``n`` slots after ``n - 1`` decode steps in each."""
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg, 2)
    jp = jax.tree.map(lambda t: t[0], jparams["layers"]["attn"])
    p = tree_map(lambda t: t[0], params["layers"]["attn"])
    x = np.random.default_rng(seed).normal(0, 1, (2, n, cfg.d_model)).astype(
        np.float32)
    kw, jkw = _mla_kw(cfg)
    cache = tree_map(lambda t: t[0], S.init_caches(cfg, 2, n, device="cpu"))
    jcache = jax.tree.map(lambda t: t[0], jS.init_caches(jcfg, 2, n))
    jstep = jax.jit(lambda p, x, c, i: jL.mla_attention(
        p, x, kv_cache=c, cache_index=i, **jkw))
    for t in range(n - 1):
        _, jcache = jstep(jp, jnp.asarray(x[:, t:t + 1]), jcache, jnp.int32(t))
        L.mla_attention(p, torch.tensor(x[:, t:t + 1]), kv_cache=cache,
                        cache_index=t, **kw)
    return jp, p, jcache, cache, x, kw, jstep


def test_mla_decode_writes_the_last_slot():
    """The step at ``cache_index = S_max - 1`` lands in the last slot of
    ``ckv`` and ``krope``, its output and the caches as the reference's."""
    jp, p, jcache, cache, x, kw, jstep = _mla_steps(8, 9)
    want, jcache = jstep(jp, jnp.asarray(x[:, 7:]), jcache, jnp.int32(7))
    assert not cache["ckv"][:, 7].any()
    got, _ = L.mla_attention(p, torch.tensor(x[:, 7:]), kv_cache=cache,
                             cache_index=7, **kw)
    assert bool(cache["ckv"][:, 7].any()) and bool(cache["krope"][:, 7].any())
    _assert_layer_close(got, want)
    for k in ("ckv", "krope"):
        _assert_layer_close(cache[k], jcache[k], k)


@pytest.mark.parametrize("index,s", [(8, 1), (7, 2), (20, 1)])
def test_mla_decode_past_the_cache_raises(index, s):
    """As GQA's: a write running past the latent cache's 8 slots raises
    before anything is written (the reference clamps it)."""
    _, p, _, cache, _, kw, _ = _mla_steps(8, 9)
    before = {k: v.clone() for k, v in cache.items()}
    with pytest.raises(ValueError, match="past the cache"):
        L.mla_attention(p, torch.ones(2, s, 64), kv_cache=cache,
                        cache_index=index, **kw)
    for k in ("ckv", "krope"):
        assert torch.equal(cache[k], before[k])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_prefill_logits_match_the_reference(pair):
    jcfg, cfg, jparams, params, tokens = pair
    toks = tokens[:, :PREFILL]
    want = np.asarray(jax.jit(j_prefill(jcfg))(
        jparams, {"tokens": jnp.asarray(toks)}))
    got = make_prefill_step(cfg)(params, {"tokens": torch.tensor(toks)})
    assert tuple(got.shape) == (2, cfg.vocab)
    assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want)


def test_forward_logits_match_the_reference(forwards):
    want, got = forwards
    assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want)


def test_chunked_forward_matches_dense(pair, forwards):
    """S = 40 through chunked MLA (chunk 8: 5 blocks a sequence) against
    the dense forward, and against the reference's chunked forward."""
    jcfg, cfg, jparams, params, tokens = pair
    _, dense = forwards
    cfg8 = dataclasses.replace(cfg, attn_chunk=8)
    jcfg8 = dataclasses.replace(jcfg, attn_chunk=8)
    chunked, _ = M.forward(cfg8, params, torch.tensor(tokens), chunked=True)
    want = np.asarray(jax.jit(lambda p, t: jM.forward(
        jcfg8, p, t, chunked=True)[0])(jparams, jnp.asarray(tokens)))
    bound = _logit_bound(dense.numpy())
    assert float((chunked - dense).abs().max()) <= bound
    assert float(np.abs(chunked.numpy() - want).max()) <= _logit_bound(want)


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
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want), t
        for k in ("ckv", "krope"):
            _assert_layer_close(caches[k], jcaches[k], f"{k} after step {t}")


def test_decode_matches_forward(pair, forwards):
    """The port alone: token-by-token decode through the latent cache
    reproduces its forward at every position."""
    _, cfg, _, params, tokens = pair
    _, full = forwards
    caches = S.init_caches(cfg, 2, T, device="cpu")
    for t in range(T):
        lg, caches = S.decode_step(cfg, params, torch.tensor(tokens[:, t:t + 1]),
                                   caches, t)
        want = full[:, t].numpy()
        assert float(np.abs(lg.numpy() - want).max()) <= _logit_bound(want), t


def test_dense_layer_with_mla_matches_the_reference(pair):
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
        _assert_layer_close(got, want, f"chunked={chunked}")


def test_bf16_forward_is_finite():
    cfg = get_config(ARCH).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 32),
                           generator=torch.Generator().manual_seed(0))
    for chunked in (False, True):
        logits, _ = M.forward(cfg, params, tokens, chunked=chunked)
        assert logits.dtype == torch.bfloat16
        assert bool(torch.isfinite(logits.float()).all())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_serve_returns_valid_tokens():
    kw = dict(batch=2, prompt_len=6, new_tokens=8, reduced=True, device="cpu")
    gen, tps = serve(ARCH, **kw)
    cfg = get_config(ARCH).reduced()
    assert tuple(gen.shape) == (2, 8) and tps > 0
    assert int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab
    again, _ = serve(ARCH, **kw)
    assert torch.equal(gen, again)  # seeded


def test_serve_main_prints(capsys):
    serve_main(["--arch", ARCH, "--batch", "2", "--tokens", "3",
                "--device", "cpu"])
    assert "generated (2, 3) tokens" in capsys.readouterr().out


def test_serve_main_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--arch", ARCH, "--tokens", "2"])
