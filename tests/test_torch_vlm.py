"""The port's VLM family (Llama-3.2-11B-Vision: groups of dense GQA layers,
each closed by a gated cross-attention layer over a vision stub) on CPU
tensors against the reference's, at the reduced config in float32
(``dataclasses.replace(cfg.reduced(), dtype="float32")``: cross_every 2, 4
query heads over 2 KV heads, attention chunk 16, vis_seq 16), with 1 group
(the reduced 2 layers) and 2 groups (4 layers), so that the group loop and
the nested ``(n_cross, cross_every - 1, ...)`` stacks and caches run.

The cross layers' ``gate`` params start at zero, and ``tanh(0) = 0`` would
hide the whole cross path from every logits check: every test here sets
the gates non-zero in the reference's params before they cross to the port
(:func:`_params`), and one test shows that the logits then move with the
vision input.

Bounds: the prefill logits at S = 32 and the ``forward`` logits at S = 40
within 5e-4 max(1, max|logit|); each of 24 ``decode_step``s after
``prefill_cross_caches`` within atol 2e-4, and the caches after them;
``cross_attn_block`` alone within 2e-5 max(1, max|out|) (dense at 16
queries, chunked at 3072 with ``q_chunk`` 1024 and at 2560 with one
2560-query chunk); specs, ``param_count`` and caches field by field; params
and caches carried across bit for bit.  The inputs are made with numpy from
a seed and fed to both packages; the reference's steps run under
``jax.jit``.
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
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import serving as S  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402

ARCH = "llama32_vision_11b"
T = 40
PREFILL = 32  # a multiple of the reduced attention chunk of 16
STEPS = 24
LAYER_TOL = 2e-5
GROUPS = {"1group": 2, "2groups": 4}  # n_layers at the reduced cross_every 2


def _cfgs(dtype="float32", **change):
    return (dataclasses.replace(j_get_config(ARCH).reduced(), dtype=dtype,
                                **change),
            dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype,
                                **change))


@functools.lru_cache(maxsize=None)
def _jit_init(jcfg):
    return jax.jit(lambda k: jM.init_params(jcfg, k))


def _gated(jcfg, jparams):
    """The reference's params with every cross layer's gate set non-zero
    (0.5, 0.75, ... a group), so that the cross path reaches the logits."""
    gate = jparams["cross"]["gate"]
    vals = 0.5 + 0.25 * jnp.arange(gate.shape[0], dtype=jnp.float32)
    cross = dict(jparams["cross"], gate=vals[:, None].astype(gate.dtype))
    return dict(jparams, cross=cross)


def _params(jcfg, seed=0, gated=True):
    jparams = _jit_init(jcfg)(jax.random.PRNGKey(seed))
    if gated:
        jparams = _gated(jcfg, jparams)
    return jparams, interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _vision(cfg, seed=2, batch=2):
    return np.random.default_rng(seed).normal(
        0, 1, (batch, cfg.vis_seq, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module", params=list(GROUPS), ids=list(GROUPS))
def pair(request):
    """The reduced f32 config (1 or 2 groups) in both packages, the
    reference's gated params, the same params in the port, (2, T) tokens
    and a (2, vis_seq, d) vision stub."""
    jcfg, cfg = _cfgs(n_layers=GROUPS[request.param])
    jparams, params = _params(jcfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, T))
    return jcfg, cfg, jparams, params, tokens, _vision(cfg)


@pytest.fixture(scope="module")
def forwards(pair):
    """The reference's and the port's forward logits over all T tokens."""
    jcfg, cfg, jparams, params, tokens, vision = pair
    want = jax.jit(lambda p, t, v: jM.forward(jcfg, p, t, vision=v)[0])(
        jparams, jnp.asarray(tokens), jnp.asarray(vision))
    got, caches = M.forward(cfg, params, torch.tensor(tokens),
                            vision=torch.tensor(vision))
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
    return 5e-4 * max(1.0, float(np.abs(want).max()))


def _assert_layer_close(got, want, what=""):
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= LAYER_TOL * max(1.0, float(np.abs(want).max())), (what, err)


# ---------------------------------------------------------------------------
# configs, specs, params and caches
# ---------------------------------------------------------------------------


def test_config_matches_the_reference():
    for full in (True, False):
        j, t = j_get_config(ARCH), get_config(ARCH)
        if not full:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.cross_every, cfg.vis_seq) == ("vlm", 5, 1601)
    assert cfg.source == "hf:meta-llama/Llama-3.2-11B-Vision"
    assert get_config("llama32-vision-11b") is cfg


@pytest.mark.parametrize("size", ["full", "reduced", "reduced-2groups"])
def test_param_count_and_specs_match_the_reference(size):
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    if size != "full":
        change = {"n_layers": 4} if size == "reduced-2groups" else {}
        cfg = dataclasses.replace(cfg.reduced(), **change)
        jcfg = dataclasses.replace(jcfg.reduced(), **change)
    assert cfg.param_count() == jcfg.param_count()
    specs = _flat(M.build_param_specs(cfg))
    jspecs = _flat(jM.build_param_specs(jcfg))
    assert set(specs) == set(jspecs)
    for k, s in specs.items():
        assert (s.shape, s.axes, s.scale) == (jspecs[k].shape, jspecs[k].axes,
                                             jspecs[k].scale), k
    n_cross = cfg.n_layers // cfg.cross_every
    assert specs["/layers/attn/wq"].shape[:2] == (n_cross, cfg.cross_every - 1)
    assert specs["/cross/gate"].shape == (n_cross, 1)
    assert specs["/cross/gate"].scale == "zero"
    if size == "full":
        assert cfg.param_count() == 8_365_838_344  # 16.7 GB at bf16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", list(GROUPS))
def test_caches_match_the_reference(dtype, groups):
    jcfg, cfg = _cfgs(dtype, n_layers=GROUPS[groups])
    specs = _flat(S.build_cache_specs(cfg, 3, 24))
    jspecs = _flat(jS.build_cache_specs(jcfg, 3, 24))
    assert set(specs) == set(jspecs) == {"/self/k", "/self/v", "/cross/k",
                                         "/cross/v"}
    for k, s in specs.items():
        assert (s.shape, s.axes, s.scale) == (
            jspecs[k].shape, jspecs[k].axes, jspecs[k].scale), k
    got = _flat(S.init_caches(cfg, 3, 24, device="cpu"))
    want = _flat(jS.init_caches(jcfg, 3, 24))
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
        assert t.dtype == getattr(torch, dtype) and not t.any(), k
    n_cross = cfg.n_layers // cfg.cross_every
    assert got["/self/k"].shape == (n_cross, 1, 3, 24, 2, 16)
    assert got["/cross/k"].shape == (n_cross, 3, cfg.vis_seq, 2, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_and_caches_carry_across_exactly(dtype):
    """The nested (n_cross, cross_every - 1, ...) stacks, the non-zero
    gates and filled cross caches cross bit for bit (bf16 as bit
    patterns)."""
    jcfg, _ = _cfgs(dtype, n_layers=4)
    jparams = _gated(jcfg, _jit_init(jcfg)(jax.random.PRNGKey(3)))
    jcaches = jS.prefill_cross_caches(
        jcfg, jparams, jS.init_caches(jcfg, 2, 8),
        vision=jnp.asarray(_vision(jcfg)).astype(dtype))
    for tree in (jparams, jcaches):
        want = _flat(jax.tree.map(np.asarray, tree))
        got = _flat(interop.lm_params_from_numpy(
            jax.tree.map(np.asarray, tree), device="cpu"))
        assert set(got) == set(want)
        for k, t in got.items():
            w = want[k]
            assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == w.shape
            if dtype == "bfloat16":
                t, w = t.view(torch.int16), w.view(np.int16)
            np.testing.assert_array_equal(t.numpy(), w, err_msg=k)
    assert bool((jparams["cross"]["gate"] != 0).all())
    assert bool(jnp.abs(jcaches["cross"]["k"]).max() > 0)


# ---------------------------------------------------------------------------
# the cross-attention block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq", [16, 3072, 2560],
                         ids=["dense", "chunked-1024", "one-chunk"])
@pytest.mark.parametrize("source", ["kv_src", "cache"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
def test_cross_attn_block_matches_the_reference(sq, source, gated):
    """One cross layer on ``sq`` queries against the 16-wide vision
    source: dense at 16 queries, and past 2048 flash-chunked with 1024
    query chunks (3072) or one chunk of all 2560 (2560 % 1024 != 0), the
    source one key block; K/V projected from the source or read from a
    cache of the same projections; with the gate, or with it removed."""
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg, 4)
    jp = jax.tree.map(lambda t: t[0], jparams["cross"])
    p = tree_map(lambda t: t[0], params["cross"])
    if not gated:
        jp = {k: v for k, v in jp.items() if k != "gate"}
        p = {k: v for k, v in p.items() if k != "gate"}
    rng = np.random.default_rng(sq)
    x = rng.normal(0, 1, (1, sq, cfg.d_model)).astype(np.float32)
    src = _vision(cfg, 5, batch=1)
    jcache = cache = None
    if source == "cache":
        jcache = {n: jnp.einsum("bsd,dhk->bshk", jnp.asarray(src), jp["w" + n])
                  for n in ("k", "v")}
        cache = {n: torch.tensor(np.asarray(v)) for n, v in jcache.items()}
    jctx = jB.LayerCtx(mode="prefill")
    want, _ = jax.jit(lambda p, x, s, c: jB.cross_attn_block(
        jcfg, p, x, s, jctx, c))(jp, jnp.asarray(x), jnp.asarray(src), jcache)
    got, aux = B.cross_attn_block(cfg, p, torch.tensor(x), torch.tensor(src),
                                  B.LayerCtx(mode="prefill"), cache)
    assert aux == 0.0
    assert tuple(got.shape) == x.shape
    _assert_layer_close(got, want, (sq, source, gated))
    # the cross path is live: the block changes x
    assert float((got - torch.tensor(x)).abs().max()) > 1e-3


@pytest.mark.parametrize("sq,skv,grid", [
    (16, 16, None), (2048, 1601, None), (3072, 1601, (1024, 1601)),
    (2560, 1500, (2560, 1500)), (4096, 3000, (1024, 1500)),
    (3072, 2053, (1024, 2053)), (3072, 4096, (1024, 2048))])
def test_cross_chunk_grid(sq, skv, grid, monkeypatch):
    """Which dataflow and which grid the block picks: dense up to 2048
    queries; past it 1024-query chunks when they divide, a source up to
    2048 as one key block (Llama's 1601, Whisper's 1500), a longer one in
    its largest divisor in 512..2048, or whole when it has none (2053 is
    prime).  The chunks always divide, as ``chunked_attention`` needs."""
    seen = []
    monkeypatch.setattr(B, "chunked_attention",
                        lambda q, k, v, **kw: seen.append(kw) or q)
    monkeypatch.setattr(B, "dense_attention",
                        lambda q, k, v, **kw: seen.append(kw) or q)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                              n_heads=2, n_kv_heads=2, d_head=2, d_model=4)
    p = {"wq": torch.zeros(4, 2, 2), "wk": torch.zeros(4, 2, 2),
         "wv": torch.zeros(4, 2, 2), "wo": torch.zeros(2, 2, 4),
         "norm": torch.ones(4)}
    B.cross_attn_block(cfg, p, torch.zeros(1, sq, 4), torch.zeros(1, skv, 4),
                       B.LayerCtx())
    if grid is None:
        assert seen == [dict(causal=False)]
    else:
        assert seen == [dict(causal=False, q_chunk=grid[0], kv_chunk=grid[1])]
        assert sq % grid[0] == 0 and skv % grid[1] == 0


def test_cross_attn_block_with_a_long_source_matches_the_reference():
    """3072 queries against a 3000-wide source: 1024 x 1500 blocks."""
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg, 6)
    jp = jax.tree.map(lambda t: t[0], jparams["cross"])
    p = tree_map(lambda t: t[0], params["cross"])
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (1, 3072, cfg.d_model)).astype(np.float32)
    src = rng.normal(0, 1, (1, 3000, cfg.d_model)).astype(np.float32)
    jctx = jB.LayerCtx()
    want, _ = jax.jit(lambda p, x, s: jB.cross_attn_block(
        jcfg, p, x, s, jctx))(jp, jnp.asarray(x), jnp.asarray(src))
    got, _ = B.cross_attn_block(cfg, p, torch.tensor(x), torch.tensor(src),
                                B.LayerCtx())
    _assert_layer_close(got, want)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_prefill_logits_match_the_reference(pair):
    jcfg, cfg, jparams, params, tokens, vision = pair
    toks = tokens[:, :PREFILL]
    want = np.asarray(jax.jit(j_prefill(jcfg))(
        jparams, {"tokens": jnp.asarray(toks), "vision": jnp.asarray(vision)}))
    got = make_prefill_step(cfg)(params, {"tokens": torch.tensor(toks),
                                          "vision": torch.tensor(vision)})
    assert tuple(got.shape) == (2, cfg.vocab)
    assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want)


def test_forward_logits_match_the_reference(forwards):
    want, got = forwards
    assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want)


def test_prefill_cross_caches_match_the_reference(pair):
    jcfg, cfg, jparams, params, _, vision = pair
    want = jS.prefill_cross_caches(jcfg, jparams, jS.init_caches(jcfg, 2, 8),
                                   vision=jnp.asarray(vision))
    caches = S.init_caches(cfg, 2, 8, device="cpu")
    cross_k = caches["cross"]["k"]
    out = S.prefill_cross_caches(cfg, params, caches,
                                 vision=torch.tensor(vision))
    assert out is caches and out["cross"]["k"] is cross_k  # in place
    for k in ("k", "v"):
        _assert_layer_close(caches["cross"][k], want["cross"][k], k)
        assert not caches["self"][k].any()


def test_decode_steps_match_the_reference(pair):
    """24 decode steps after ``prefill_cross_caches``, each step's logits
    within atol 2e-4, the nested self caches and the cross caches after
    them as the reference's."""
    jcfg, cfg, jparams, params, tokens, vision = pair
    jcaches = jS.prefill_cross_caches(
        jcfg, jparams, jS.init_caches(jcfg, 2, STEPS),
        vision=jnp.asarray(vision))
    caches = S.prefill_cross_caches(
        cfg, params, S.init_caches(cfg, 2, STEPS, device="cpu"),
        vision=torch.tensor(vision))
    cross = caches["cross"]["k"].clone()
    jstep = jax.jit(lambda p, t, c, i: jS.decode_step(jcfg, p, t, c, i))
    step = make_decode_step(cfg)
    for t in range(STEPS):
        want, jcaches = jstep(jparams, jnp.asarray(tokens[:, t:t + 1]),
                              jcaches, jnp.int32(t))
        got, out = step(params, torch.tensor(tokens[:, t:t + 1]), caches, t)
        assert out is caches
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                                   err_msg=f"step {t}")
    for k, t in _flat(caches).items():
        np.testing.assert_allclose(t.numpy(), np.asarray(_flat(jcaches)[k]),
                                   atol=2e-4, err_msg=k)
    assert torch.equal(caches["cross"]["k"], cross)  # read, never written
    assert bool(caches["self"]["k"][:, :, :, STEPS - 1].any())


def test_decode_matches_forward(pair, forwards):
    """The port alone: token-by-token decode over the cross caches
    reproduces its forward over the vision stub at every position."""
    _, cfg, _, params, tokens, vision = pair
    _, full = forwards
    caches = S.prefill_cross_caches(
        cfg, params, S.init_caches(cfg, 2, T, device="cpu"),
        vision=torch.tensor(vision))
    for t in range(T):
        lg, caches = S.decode_step(cfg, params,
                                   torch.tensor(tokens[:, t:t + 1]), caches, t)
        want = full[:, t].numpy()
        assert float(np.abs(lg.numpy() - want).max()) <= _logit_bound(want), t


def test_logits_move_with_the_vision_input(pair, forwards):
    """With the gates non-zero another vision stub changes the logits by
    far more than the parity bound; with the reference's zero gates the
    same change moves nothing (``tanh(0) = 0``)."""
    jcfg, cfg, jparams, params, tokens, vision = pair
    _, got = forwards
    other = torch.tensor(_vision(cfg, 9))
    moved, _ = M.forward(cfg, params, torch.tensor(tokens), vision=other)
    assert float((moved - got).abs().max()) > 100 * _logit_bound(got.numpy())
    _, zero = _params(jcfg, gated=False)
    a, _ = M.forward(cfg, zero, torch.tensor(tokens),
                     vision=torch.tensor(vision))
    b, _ = M.forward(cfg, zero, torch.tensor(tokens), vision=other)
    assert torch.equal(a, b)


def test_dense_layer_of_a_group_matches_the_reference(pair):
    jcfg, cfg, jparams, params, _, _ = pair
    x = np.random.default_rng(5).normal(0, 1, (2, 32, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree.map(lambda t: t[-1, 0], jparams["layers"])
    p = tree_map(lambda t: t[-1, 0], params["layers"])
    for chunked in (False, True):
        jctx = jB.LayerCtx(mode="prefill", chunked=chunked)
        want, _, _ = jax.jit(lambda p, x: jB.dense_layer(jcfg, p, x, jctx))(
            jp, jnp.asarray(x))
        got, cache, aux = B.dense_layer(
            cfg, p, torch.tensor(x), B.LayerCtx(mode="prefill", chunked=chunked))
        assert cache is None and aux == 0.0
        _assert_layer_close(got, want, f"chunked={chunked}")


# ---------------------------------------------------------------------------
# stub dtypes
# ---------------------------------------------------------------------------


def test_f32_model_takes_bf16_vision_as_the_reference():
    """The reference makes its stubs in bf16 even for f32 configs and
    ``jnp`` promotes them against the f32 weights; the port promotes once
    where the stub enters.  Prefill, ``forward`` and decode after
    ``prefill_cross_caches``, all fed the same bf16 stub."""
    jcfg, cfg = _cfgs(n_layers=4)
    jparams, params = _params(jcfg, 8)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, PREFILL))
    jv = jnp.asarray(_vision(cfg, 4)).astype(jnp.bfloat16)
    v = interop.lm_params_from_numpy({"v": np.asarray(jv)}, device="cpu")["v"]
    assert v.dtype == torch.bfloat16
    want = np.asarray(jax.jit(lambda p, t, v: jM.forward(
        jcfg, p, t, vision=v)[0])(jparams, jnp.asarray(tokens), jv))
    got, _ = M.forward(cfg, params, torch.tensor(tokens), vision=v)
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want)
    want = np.asarray(jax.jit(j_prefill(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens), "vision": jv}))
    got = make_prefill_step(cfg)(params, {"tokens": torch.tensor(tokens),
                                          "vision": v})
    assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want)
    jc = jS.prefill_cross_caches(jcfg, jparams, jS.init_caches(jcfg, 2, 4),
                                 vision=jv)
    c = S.prefill_cross_caches(cfg, params,
                               S.init_caches(cfg, 2, 4, device="cpu"),
                               vision=v)
    for t in range(4):
        want, jc = jS.decode_step(jcfg, jparams, jnp.asarray(tokens[:, t:t + 1]),
                                  jc, jnp.int32(t))
        got, c = S.decode_step(cfg, params, torch.tensor(tokens[:, t:t + 1]),
                               c, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_a_wider_stub_is_refused():
    cfg = get_config(ARCH).reduced()  # bf16
    params = M.init_params(cfg, 0, device="cpu")
    tokens = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="stub input"):
        M.forward(cfg, params, tokens,
                  vision=torch.zeros(1, cfg.vis_seq, cfg.d_model))
    with pytest.raises(ValueError, match="stub input"):
        S.prefill_cross_caches(cfg, params,
                               S.init_caches(cfg, 1, 4, device="cpu"),
                               vision=torch.zeros(1, cfg.vis_seq, cfg.d_model))


def test_bf16_forward_is_finite():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=4)
    params = M.init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
    vision = torch.randn(2, cfg.vis_seq, cfg.d_model, generator=gen,
                         dtype=torch.bfloat16)
    for chunked in (False, True):
        logits, _ = M.forward(cfg, params, tokens, chunked=chunked,
                              vision=vision)
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


def test_serve_fills_the_cross_caches_first(monkeypatch):
    from repro_torch.launch import serve as serve_mod

    calls = []
    real = serve_mod.prefill_cross_caches

    def recording(cfg, params, caches, **kw):
        calls.append({k: None if v is None else (tuple(v.shape), v.dtype)
                      for k, v in kw.items()})
        return real(cfg, params, caches, **kw)

    monkeypatch.setattr(serve_mod, "prefill_cross_caches", recording)
    serve(ARCH, batch=2, prompt_len=2, new_tokens=2, device="cpu")
    cfg = get_config(ARCH).reduced()
    assert calls == [dict(vision=((2, cfg.vis_seq, cfg.d_model),
                                  torch.bfloat16), frames=None)]


def test_serve_main_prints(capsys):
    serve_main(["--arch", ARCH, "--batch", "2", "--tokens", "3",
                "--device", "cpu"])
    assert "generated (2, 3) tokens" in capsys.readouterr().out


def test_serve_main_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--arch", ARCH, "--tokens", "2"])
