"""The port's encoder-decoder audio family (Whisper-large-v3: a non-causal
encoder over a frame stub, then decoder layers of causal self-attention and
ungated cross-attention to the encoder's states, LayerNorm and GELU) on
CPU tensors against the reference's, at the reduced config in float32
(``dataclasses.replace(cfg.reduced(), dtype="float32")``: 2 encoder and 2
decoder layers, 4 heads of 16 (2 KV heads), attention chunk 16, enc_seq
16); and ``layer_norm`` and ``gelu_mlp`` against the reference's at f32
and bf16.

Bounds: the prefill logits at S = 32 and the ``forward`` logits at S = 40
within 5e-4 max(1, max|logit|); each of 24 ``decode_step``s after
``prefill_cross_caches`` (which runs the encoder) within atol 2e-4, and the
caches after them; a layer alone within 2e-5 max(1, max|out|) at f32; at
bf16 ``layer_norm`` within 2^-7 max(1, max|out|) (one rounding flip of the
output) and ``gelu_mlp`` within 2^-6 max(1, max|out|) (the GELU's few bf16
roundings of the hidden units, then the output's own).  The inputs are made
with numpy from a seed and fed to both packages; the reference's steps run
under ``jax.jit``.
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

ARCH = "whisper_large_v3"
T = 40
PREFILL = 32  # a multiple of the reduced attention chunk of 16
STEPS = 24
LAYER_TOL = 2e-5
BF16_TOL = {"layer_norm": 2.0 ** -7, "gelu_mlp": 2.0 ** -6}


def _cfgs(dtype="float32", **change):
    return (dataclasses.replace(j_get_config(ARCH).reduced(), dtype=dtype,
                                **change),
            dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype,
                                **change))


@functools.lru_cache(maxsize=None)
def _jit_init(jcfg):
    return jax.jit(lambda k: jM.init_params(jcfg, k))


def _biased(jparams, seed):
    """The reference's params with every LayerNorm bias and scale moved
    off its init (0 and 1), so that the biases and scales are read."""
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if "norm" in name:
            base = 0.0 if name.endswith("_b") else 1.0
            return tree + jnp.asarray(
                rng.normal(base, 0.1, tree.shape) - base).astype(tree.dtype)
        return tree

    return walk(jparams)


def _params(jcfg, seed=0):
    jparams = _biased(_jit_init(jcfg)(jax.random.PRNGKey(seed)), seed)
    return jparams, interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _frames(cfg, seed=2, batch=2):
    return np.random.default_rng(seed).normal(
        0, 1, (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """The reduced f32 config in both packages, the reference's params
    (norms moved off their init), the same params in the port, (2, T)
    tokens and a (2, enc_seq, d) frame stub."""
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, T))
    return jcfg, cfg, jparams, params, tokens, _frames(cfg)


@pytest.fixture(scope="module")
def forwards(pair):
    """The reference's and the port's forward logits over all T tokens."""
    jcfg, cfg, jparams, params, tokens, frames = pair
    want = jax.jit(lambda p, t, f: jM.forward(jcfg, p, t, frames=f)[0])(
        jparams, jnp.asarray(tokens), jnp.asarray(frames))
    got, caches = M.forward(cfg, params, torch.tensor(tokens),
                            frames=torch.tensor(frames))
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


def _assert_layer_close(got, want, what="", tol=LAYER_TOL):
    want = np.asarray(want, dtype=np.float32)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _both(a, dtype):
    """A float32 numpy array as the reference's array and the port's
    tensor of the same values in ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    return j, interop.lm_params_from_numpy({"a": np.asarray(j)},
                                           device="cpu")["a"]


# ---------------------------------------------------------------------------
# LayerNorm and the GELU MLP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 17, 64), (2, 5, 1280)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_the_reference(dtype, shape):
    rng = np.random.default_rng(shape[-1])
    x = (rng.normal(0, 2, shape) + 0.5).astype(np.float32)
    scale = rng.normal(1, 0.2, shape[-1:]).astype(np.float32)
    bias = rng.normal(0, 0.2, shape[-1:]).astype(np.float32)
    (jx, tx), (js, ts), (jb, tb) = (_both(a, dtype) for a in (x, scale, bias))
    want = jax.jit(jL.layer_norm)(jx, js, jb)
    got = L.layer_norm(tx, ts, tb)
    assert got.dtype == getattr(torch, dtype)
    tol = LAYER_TOL if dtype == "float32" else BF16_TOL["layer_norm"]
    _assert_layer_close(got, want.astype(jnp.float32), tol=tol)


def test_layer_norm_is_not_torchs_at_bf16():
    """``F.layer_norm`` applies the weight before its bf16 cast; the
    reference casts the normalized value first.  The port follows the
    reference, bit for bit here."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (4, 64, 256)).astype(np.float32)
    scale = rng.normal(1, 0.5, (256,)).astype(np.float32)
    bias = rng.normal(0, 0.5, (256,)).astype(np.float32)
    (jx, tx), (js, ts), (jb, tb) = (_both(a, "bfloat16")
                                    for a in (x, scale, bias))
    want = np.asarray(jax.jit(jL.layer_norm)(jx, js, jb).astype(jnp.float32))
    got = L.layer_norm(tx, ts, tb).float().numpy()
    lib = torch.nn.functional.layer_norm(tx, (256,), ts, tb, 1e-5)
    assert float(np.abs(got - want).max()) == 0.0
    assert float(np.abs(lib.float().numpy() - want).max()) > 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_the_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (3, 17, 64)).astype(np.float32)
    w_in = (rng.normal(0, 1, (64, 128)) / 8).astype(np.float32)
    w_out = (rng.normal(0, 1, (128, 64)) / 11).astype(np.float32)
    (jx, tx), (ji, ti), (jo, to) = (_both(a, dtype) for a in (x, w_in, w_out))
    want = jax.jit(jL.gelu_mlp)(jx, ji, jo)
    got = L.gelu_mlp(tx, ti, to)
    assert got.dtype == getattr(torch, dtype)
    tol = LAYER_TOL if dtype == "float32" else BF16_TOL["gelu_mlp"]
    _assert_layer_close(got, want.astype(jnp.float32), tol=tol)


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; the erf GELU
    differs from it by far more than the layer bound at f32."""
    x = np.linspace(-4, 4, 801, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    eye = torch.eye(801)
    got = L.gelu_mlp(torch.tensor(x)[None], eye, eye)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.tensor(x)).numpy()
    assert float(np.abs(erf - want).max()) > 1e-4


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
    assert (cfg.family, cfg.kind, cfg.norm, cfg.act) == (
        "audio", "encdec", "layernorm", "gelu")
    assert (cfg.enc_layers, cfg.n_layers, cfg.enc_seq) == (32, 32, 1500)
    assert cfg.source == "arXiv:2212.04356"
    assert get_config("whisper-large-v3") is cfg


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_param_count_and_specs_match_the_reference(full):
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    if not full:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert cfg.param_count() == jcfg.param_count()
    specs = _flat(M.build_param_specs(cfg))
    jspecs = _flat(jM.build_param_specs(jcfg))
    assert set(specs) == set(jspecs)
    for k, s in specs.items():
        assert (s.shape, s.axes, s.scale) == (jspecs[k].shape, jspecs[k].axes,
                                             jspecs[k].scale), k
    assert "/cross/gate" not in specs and "/cross/norm_b" in specs
    assert "/lm_head" in specs and "/enc_final_norm_b" in specs
    assert specs["/encoder/ffn/w_in"].shape[0] == cfg.enc_layers
    if full:
        assert cfg.param_count() == 1_601_198_080  # 3.2 GB at bf16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_caches_match_the_reference(dtype):
    jcfg, cfg = _cfgs(dtype)
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
    assert got["/cross/k"].shape == (2, 3, cfg.enc_seq, 2, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_and_caches_carry_across_exactly(dtype):
    jcfg, _ = _cfgs(dtype)
    jparams = _jit_init(jcfg)(jax.random.PRNGKey(3))
    jcaches = jS.prefill_cross_caches(
        jcfg, jparams, jS.init_caches(jcfg, 2, 8),
        frames=jnp.asarray(_frames(jcfg)).astype(dtype))
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


# ---------------------------------------------------------------------------
# layers and the encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("part", ["encoder", "layers"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_dense_layer_with_layernorm_and_gelu_matches_the_reference(
        pair, part, causal):
    jcfg, cfg, jparams, params, _, _ = pair
    x = np.random.default_rng(5).normal(0, 1, (2, 32, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree.map(lambda t: t[1], jparams[part])
    p = tree_map(lambda t: t[1], params[part])
    jctx = jB.LayerCtx(mode="prefill", causal=causal)
    want, _, _ = jax.jit(lambda p, x: jB.dense_layer(jcfg, p, x, jctx))(
        jp, jnp.asarray(x))
    got, cache, aux = B.dense_layer(cfg, p, torch.tensor(x),
                                    B.LayerCtx(mode="prefill", causal=causal))
    assert cache is None and aux == 0.0
    _assert_layer_close(got, want, (part, causal))


@pytest.mark.parametrize("sq", [16, 3072, 2560],
                         ids=["dense", "chunked-1024", "one-chunk"])
@pytest.mark.parametrize("source", ["kv_src", "cache"])
def test_cross_attn_block_matches_the_reference(pair, sq, source):
    """Whisper's ungated cross layer (LayerNorm with its bias) on ``sq``
    queries against the 16-frame encoder states: dense, chunked with 1024
    query chunks, one 2560-query chunk; K/V from the states or a cache."""
    jcfg, cfg, jparams, params, _, _ = pair
    jp = jax.tree.map(lambda t: t[1], jparams["cross"])
    p = tree_map(lambda t: t[1], params["cross"])
    assert "gate" not in p
    rng = np.random.default_rng(sq)
    x = rng.normal(0, 1, (1, sq, cfg.d_model)).astype(np.float32)
    src = _frames(cfg, 6, batch=1)
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
    _assert_layer_close(got, want, (sq, source))


def test_encoder_matches_the_reference(pair):
    jcfg, cfg, jparams, params, _, frames = pair
    want = jax.jit(lambda p, f: jM._whisper_encoder(jcfg, p, f))(
        jparams, jnp.asarray(frames))
    got = M._whisper_encoder(cfg, params, torch.tensor(frames))
    assert tuple(got.shape) == frames.shape
    _assert_layer_close(got, want)


def test_encoder_is_bidirectional(pair):
    """Changing the last frame changes the encoder's first state: no
    causal mask.  (The change is a random vector: a constant added to
    every feature would vanish in the LayerNorms.)"""
    jcfg, cfg, jparams, params, _, frames = pair
    f = frames.copy()
    f[:, -1] = _frames(cfg, 12)[:, 0]
    a = M._whisper_encoder(cfg, params, torch.tensor(frames))
    b = M._whisper_encoder(cfg, params, torch.tensor(f))
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-3
    want = jax.jit(lambda p, f: jM._whisper_encoder(jcfg, p, f))(
        jparams, jnp.asarray(f))
    _assert_layer_close(b, want)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_prefill_logits_match_the_reference(pair):
    jcfg, cfg, jparams, params, tokens, frames = pair
    toks = tokens[:, :PREFILL]
    want = np.asarray(jax.jit(j_prefill(jcfg))(
        jparams, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}))
    got = make_prefill_step(cfg)(params, {"tokens": torch.tensor(toks),
                                          "frames": torch.tensor(frames)})
    assert tuple(got.shape) == (2, cfg.vocab)
    assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want)


def test_forward_logits_match_the_reference(forwards):
    want, got = forwards
    assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want)


def test_prefill_cross_caches_match_the_reference(pair):
    jcfg, cfg, jparams, params, _, frames = pair
    want = jS.prefill_cross_caches(jcfg, jparams, jS.init_caches(jcfg, 2, 8),
                                   frames=jnp.asarray(frames))
    caches = S.init_caches(cfg, 2, 8, device="cpu")
    cross_v = caches["cross"]["v"]
    out = S.prefill_cross_caches(cfg, params, caches,
                                 frames=torch.tensor(frames))
    assert out is caches and out["cross"]["v"] is cross_v  # in place
    for k in ("k", "v"):
        _assert_layer_close(caches["cross"][k], want["cross"][k], k)
        assert not caches["self"][k].any()


def test_decode_steps_match_the_reference(pair):
    """24 decode steps after ``prefill_cross_caches`` (the encoder runs
    there, once), each within atol 2e-4, the caches after them too."""
    jcfg, cfg, jparams, params, tokens, frames = pair
    jcaches = jS.prefill_cross_caches(
        jcfg, jparams, jS.init_caches(jcfg, 2, STEPS),
        frames=jnp.asarray(frames))
    caches = S.prefill_cross_caches(
        cfg, params, S.init_caches(cfg, 2, STEPS, device="cpu"),
        frames=torch.tensor(frames))
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


def test_decode_matches_forward(pair, forwards):
    _, cfg, _, params, tokens, frames = pair
    _, full = forwards
    caches = S.prefill_cross_caches(
        cfg, params, S.init_caches(cfg, 2, T, device="cpu"),
        frames=torch.tensor(frames))
    for t in range(T):
        lg, caches = S.decode_step(cfg, params,
                                   torch.tensor(tokens[:, t:t + 1]), caches, t)
        want = full[:, t].numpy()
        assert float(np.abs(lg.numpy() - want).max()) <= _logit_bound(want), t


def test_decode_with_frames_runs_the_encoder_for_nothing(pair, monkeypatch):
    """As in the reference: ``frames`` passed to a decode step run the
    encoder again, and the step still reads the cross caches."""
    _, cfg, _, params, tokens, frames = pair
    caches = S.prefill_cross_caches(
        cfg, params, S.init_caches(cfg, 2, 2, device="cpu"),
        frames=torch.tensor(frames))
    runs = []
    real = M._whisper_encoder
    monkeypatch.setattr(M, "_whisper_encoder",
                        lambda *a: runs.append(1) or real(*a))
    plain, _ = S.decode_step(cfg, params, torch.tensor(tokens[:, :1]),
                             tree_map(torch.clone, caches), 0)
    other = torch.tensor(_frames(cfg, 11))
    with_frames, _ = S.decode_step(cfg, params, torch.tensor(tokens[:, :1]),
                                   caches, 0, frames=other)
    assert len(runs) == 1 and torch.equal(plain, with_frames)


def test_logits_move_with_the_frames(pair, forwards):
    """Whisper's cross-attention is ungated, so it is always live."""
    _, cfg, _, params, tokens, _ = pair
    _, got = forwards
    moved, _ = M.forward(cfg, params, torch.tensor(tokens),
                         frames=torch.tensor(_frames(cfg, 9)))
    assert float((moved - got).abs().max()) > 100 * _logit_bound(got.numpy())


def test_f32_model_takes_bf16_frames_promoted():
    """bf16 frames into the f32 model.  The reference refuses them: its
    encoder scan's carry would change dtype in the first layer (bf16 in,
    f32 out).  The port promotes the stub once where it enters, so it
    equals the reference fed the same frames promoted to f32: prefill,
    ``forward`` and the cross caches."""
    jcfg, cfg = _cfgs()
    jparams, params = _params(jcfg, 8)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, PREFILL))
    jf, f = _both(_frames(cfg, 4), "bfloat16")
    with pytest.raises(TypeError, match="carry"):
        jM.forward(jcfg, jparams, jnp.asarray(tokens), frames=jf)
    jf = jf.astype(jnp.float32)
    want = np.asarray(jax.jit(lambda p, t, f: jM.forward(
        jcfg, p, t, frames=f)[0])(jparams, jnp.asarray(tokens), jf))
    got, _ = M.forward(cfg, params, torch.tensor(tokens), frames=f)
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want)
    want = np.asarray(jax.jit(j_prefill(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens), "frames": jf}))
    got = make_prefill_step(cfg)(params, {"tokens": torch.tensor(tokens),
                                          "frames": f})
    assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want)
    jc = jS.prefill_cross_caches(jcfg, jparams, jS.init_caches(jcfg, 2, 4),
                                 frames=jf)
    c = S.prefill_cross_caches(cfg, params,
                               S.init_caches(cfg, 2, 4, device="cpu"),
                               frames=f)
    for k in ("k", "v"):
        _assert_layer_close(c["cross"][k], jc["cross"][k], k)


def test_a_wider_stub_is_refused():
    cfg = get_config(ARCH).reduced()  # bf16
    params = M.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="stub input"):
        M.forward(cfg, params, torch.zeros(1, 4, dtype=torch.long),
                  frames=torch.zeros(1, cfg.enc_seq, cfg.d_model))


def test_bf16_forward_is_finite():
    cfg = get_config(ARCH).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
    frames = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=gen,
                         dtype=torch.bfloat16)
    for chunked in (False, True):
        logits, _ = M.forward(cfg, params, tokens, chunked=chunked,
                              frames=frames)
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


def test_serve_runs_the_encoder_once(monkeypatch):
    """In ``prefill_cross_caches``, once a request; no decode step runs
    it."""
    runs = []
    real = M._whisper_encoder

    def recording(cfg, p, f):
        runs.append(tuple(f.shape))
        return real(cfg, p, f)

    monkeypatch.setattr(M, "_whisper_encoder", recording)
    monkeypatch.setattr(S, "_whisper_encoder", recording)
    serve(ARCH, batch=2, prompt_len=3, new_tokens=4, device="cpu")
    cfg = get_config(ARCH).reduced()
    assert runs == [(2, cfg.enc_seq, cfg.d_model)]


def test_serve_main_prints(capsys):
    serve_main(["--arch", ARCH, "--batch", "2", "--tokens", "3",
                "--device", "cpu"])
    assert "generated (2, 3) tokens" in capsys.readouterr().out


def test_serve_main_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--arch", ARCH, "--tokens", "2"])
