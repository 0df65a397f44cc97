"""The port's Hymba-1.5B hybrid path (parallel attention + Mamba heads in
every layer, sliding-window layers around global ones) on CPU tensors
against the reference's, at its reduced config in float32
(``dataclasses.replace(cfg.reduced(), dtype="float32")``: 2 layers, layer 0
global, window 16, attention chunk 16, SSD chunk 8).

The reference's params carried across by ``lm_params_from_numpy`` (bit for
bit, float32 and bfloat16, caches too); the ``make_prefill_step`` logits at
S = 32 (chunked attention, the port's SSD through ``ssd_scan_plain``, the
reference's through ``ssd_chunked``) and the ``forward`` logits at S = 40
(past the window) within 5e-4 max(1, max|logit|); each of 24
``decode_step``s within atol 2e-4 (``tests/test_torch_lm.py``'s bounds);
``hybrid_layer`` alone; the specs, ``param_count``, segments and caches
field by field; ``serve`` and its CLI on the CPU.  The reference's steps
run under ``jax.jit``.
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
from repro_torch.kernels.ssd_scan import ssd_scan as kd  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import serving as S  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402

ARCH = "hymba_1_5b"
T = 40  # past the reduced window of 16
PREFILL = 32  # a multiple of the reduced attention chunk of 16
STEPS = 24


def _cfgs(dtype="float32"):
    return (dataclasses.replace(j_get_config(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jit_init(jcfg):
    return jax.jit(lambda k: jM.init_params(jcfg, k))


def _init(jcfg, seed):
    """The reference's params under ``jax.jit`` (one compile a config, not
    one a leaf; the same values)."""
    return _jit_init(jcfg)(jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def pair():
    """The reduced f32 config in both packages, the reference's params, the
    same params in the port, and (2, T) tokens."""
    jcfg, cfg = _cfgs()
    jparams = _init(jcfg, 0)
    params = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
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
    return 5e-4 * max(1.0, float(np.abs(want).max()))


def test_config_matches_the_reference():
    for full in (True, False):
        j, t = j_get_config(ARCH), get_config(ARCH)
        if not full:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    cfg = get_config("hymba-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.ssm_heads, cfg.ssm_head_dim,
            cfg.ssm_state, cfg.window, cfg.global_layers, cfg.vocab) == (
        32, 1600, 25, 5, 64, 5504, 50, 64, 16, 1024, (0, 15, 31), 32001)
    assert cfg.source == "arXiv:2411.13676"


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
    assert specs["/global/attn/wq"].shape[0] == len(cfg.global_layers)
    assert specs["/sliding/mixer/w_in"].shape[0] == (
        cfg.n_layers - len(cfg.global_layers))


def test_full_param_count():
    """1.64 B: embed and head 51.2 M each, 48.1 M a layer x 32."""
    n = get_config(ARCH).param_count()
    assert n == j_get_config(ARCH).param_count()
    assert 1.6e9 < n < 1.7e9


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_segments_match_the_reference(full):
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    if not full:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert M._hymba_segments(cfg) == jM._hymba_segments(jcfg)
    if full:
        assert M._hymba_segments(cfg) == [("g", 1), ("s", 14), ("g", 1),
                                          ("s", 15), ("g", 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_specs_and_caches_match_the_reference(dtype):
    jcfg, cfg = _cfgs(dtype)
    specs = _flat(S.build_cache_specs(cfg, 3, 24))
    jspecs = _flat(jS.build_cache_specs(jcfg, 3, 24))
    assert set(specs) == set(jspecs) == {
        f"/{part}/{kind}/{leaf}" for part in ("global", "sliding")
        for kind, leaves in (("attn", "kv"), ("ssm", ("conv", "state")))
        for leaf in leaves}
    for k, s in specs.items():
        assert (s.shape, s.axes, s.scale) == (jspecs[k].shape, jspecs[k].axes,
                                             jspecs[k].scale), k
    got = _flat(S.init_caches(cfg, 3, 24, device="cpu"))
    want = _flat(jS.init_caches(jcfg, 3, 24))
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
        assert t.dtype == getattr(torch, dtype) and not t.any(), k
    caches = S.init_caches(cfg, 3, 24, device="cpu")
    assert S.hybrid_split_caches(cfg, caches) is caches
    fwd = S._to_forward_caches(cfg, caches)
    assert all(a is b for a, b in zip(_flat(fwd).values(),
                                      _flat(caches).values()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_and_caches_carry_across_exactly(dtype):
    """The hybrid trees (``global``/``sliding`` params, the caches'
    ``attn``/``ssm``) carry across bit for bit."""
    jcfg, _ = _cfgs(dtype)
    jparams = _init(jcfg, 3)
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


def test_prefill_logits_match_the_reference(pair):
    jcfg, cfg, jparams, params, tokens = pair
    toks = tokens[:, :PREFILL]
    want = np.asarray(jax.jit(j_prefill(jcfg))(
        jparams, {"tokens": jnp.asarray(toks)}))
    got = make_prefill_step(cfg)(params, {"tokens": torch.tensor(toks)})
    assert tuple(got.shape) == (2, cfg.vocab)
    assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want)


def test_prefill_needs_a_chunk_multiple(pair):
    _, cfg, _, params, tokens = pair
    with pytest.raises(ValueError, match="multiple of"):
        make_prefill_step(cfg)(params, {"tokens": torch.tensor(tokens[:, :24])})


def test_forward_logits_match_the_reference(forwards):
    want, got = forwards
    assert tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want)


def test_chunked_forward_matches_dense(pair, forwards):
    """The port alone: chunked attention (window and global layers) against
    dense over the first 32 positions."""
    _, cfg, _, params, tokens = pair
    want, dense = forwards
    got, _ = M.forward(cfg, params, torch.tensor(tokens[:, :PREFILL]),
                       chunked=True)
    err = float((got - dense[:, :PREFILL]).abs().max())
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
        got, caches = step(params, torch.tensor(tokens[:, t:t + 1]), caches, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                                   err_msg=f"step {t}")
    got, want = _flat(caches), _flat(jcaches)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-4, err_msg=k)


def test_decode_matches_forward(pair, forwards):
    """The port alone: token-by-token decode past the window reproduces its
    forward at every position."""
    _, cfg, _, params, tokens = pair
    _, full = forwards
    caches = S.init_caches(cfg, 2, T, device="cpu")
    for t in range(T):
        lg, caches = S.decode_step(cfg, params, torch.tensor(tokens[:, t:t + 1]),
                                   caches, t)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=2e-4,
                                   err_msg=f"step {t}")


def test_decode_updates_the_caches_in_place(pair):
    _, cfg, _, params, tokens = pair
    caches = S.init_caches(cfg, 2, 8, device="cpu")
    before = _flat(caches)
    out = S.decode_step(cfg, params, torch.tensor(tokens[:, :1]), caches, 3)[1]
    assert out is caches
    after = _flat(out)
    assert all(after[k] is before[k] and bool(after[k].any()) for k in after)
    # the attention caches hold the token at its position and nothing else
    for part in ("global", "sliding"):
        k = caches[part]["attn"]["k"]
        assert bool(k[:, :, 3].any()) and not k[:, :, :3].any()
        assert not k[:, :, 4:].any()


@pytest.mark.parametrize("part", ["global", "sliding"])
@pytest.mark.parametrize("chunked", [False, True], ids=["dense", "chunked"])
def test_hybrid_layer_matches_the_reference(pair, part, chunked):
    jcfg, cfg, jparams, params, _ = pair
    window = cfg.window if part == "sliding" else 0
    x = np.random.default_rng(5).normal(0, 1, (2, 32, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree.map(lambda t: t[0], jparams[part])
    p = tree_map(lambda t: t[0], params[part])
    jctx = jB.LayerCtx(mode="prefill", chunked=chunked, window=window)
    want, _, _ = jax.jit(lambda p, x: jB.hybrid_layer(jcfg, p, x, jctx))(
        jp, jnp.asarray(x))
    ctx = B.LayerCtx(mode="prefill", chunked=chunked, window=window)
    got, cache, aux = B.hybrid_layer(cfg, p, torch.tensor(x), ctx)
    assert cache is None and aux == 0.0
    want = np.asarray(want)
    assert float(np.abs(got.numpy() - want).max()) <= 2e-5 * max(
        1.0, float(np.abs(want).max()))


def test_unported_pieces_raise(pair):
    """Hymba's params under a LayerNorm or GELU config fail in the port as
    they do in the reference: its norms carry no bias (LayerNorm's ``+
    None`` raises ``TypeError``) and its FFN no ``w_in`` (``KeyError``)."""
    jcfg, cfg, jparams, params, _ = pair
    x = np.zeros((1, 16, cfg.d_model), np.float32)
    jp = jax.tree.map(lambda t: t[0], jparams["global"])
    p = tree_map(lambda t: t[0], params["global"])
    for change, error in ((dict(norm="layernorm"), TypeError),
                          (dict(act="gelu"), KeyError)):
        with pytest.raises(error):
            jB.hybrid_layer(dataclasses.replace(jcfg, **change), jp,
                            jnp.asarray(x), jB.LayerCtx())
        with pytest.raises(error):
            B.hybrid_layer(dataclasses.replace(cfg, **change), p,
                           torch.tensor(x), B.LayerCtx())


def test_prefill_runs_the_ssd_once_per_layer(pair, monkeypatch):
    from repro_torch.models import ssm

    _, cfg, _, params, tokens = pair
    calls = []
    real = ssm.ssd_scan

    def counting(*a, chunk):
        calls.append((a[0].shape, chunk))
        return real(*a, chunk=chunk)

    monkeypatch.setattr(ssm, "ssd_scan", counting)
    before = kd.SSD_SCAN.launches
    make_prefill_step(cfg)(params, {"tokens": torch.tensor(tokens[:, :PREFILL])})
    shape = (2, PREFILL, cfg.ssm_heads, cfg.ssm_head_dim)
    assert calls == [(shape, cfg.ssd_chunk)] * cfg.n_layers
    assert kd.SSD_SCAN.launches == before  # CPU: the plain version


def test_bf16_forward_is_finite():
    cfg = get_config(ARCH).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 32),
                           generator=torch.Generator().manual_seed(0))
    for chunked in (False, True):
        logits, _ = M.forward(cfg, params, tokens, chunked=chunked)
        assert logits.dtype == torch.bfloat16
        assert bool(torch.isfinite(logits.float()).all())


def test_serve_returns_valid_tokens():
    """Prompt and generation together run past the reduced window."""
    kw = dict(batch=2, prompt_len=6, new_tokens=14, reduced=True, device="cpu")
    gen, tps = serve(ARCH, **kw)
    cfg = get_config(ARCH).reduced()
    assert tuple(gen.shape) == (2, 14) and tps > 0
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
