"""The port's MoE decoder family (routed top-k experts with per-expert
capacity, shared experts or a dense residual MLP: Qwen1.5-MoE-A2.7B and
Arctic-480B) on CPU tensors against the reference's, at each config's
reduced size in float32 (``dataclasses.replace(cfg.reduced(),
dtype="float32")``: 2 layers, 8 experts of 32 with top-2, dispatch groups
of 32 tokens, attention chunk 16).

Exact: ``route_topk``'s choices on tied logits (lower index first, as
``lax.top_k``), ``dispatch_combine``'s dispatched and combine tensors
(drops at capacity 1 and several groups included), the params and caches
carried across by ``lm_params_from_numpy`` (bit for bit, float32 and
bfloat16), the specs, ``param_count`` and ``active_param_count``.  Within
1e-5 of the output's size (the layer): ``moe_ffn``'s ``(y, aux)`` and
``moe_layer``.  Within
1e-4 max(1, max|logit|) (logits): the ``make_prefill_step`` logits at S =
32 (2 dispatch groups), the ``forward`` logits at S = 40, each of 24
``decode_step``s against the reference's (its drops at capacity 1
included), the caches within 1e-5 after every step; the port's decode
against its own forward with ``capacity_factor = 8`` (no drops).  The
reference's capacity invariants (``tests/test_properties.py``) as
hypothesis cases on the port; ``serve`` and its CLI on the CPU.  The
reference's steps run under ``jax.jit``.
"""

import dataclasses
import functools
import importlib.util
import pathlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.steps import make_prefill_step as j_prefill  # noqa: E402
from repro.models import blocks as jB  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import serving as jS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import serving as S  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402

ARCHS = ("qwen2_moe_a2_7b", "arctic_480b")
T = 40
PREFILL = 32  # a multiple of the reduced attention chunk of 16; 2 groups
STEPS = 24
LAYER_TOL = 1e-5
REPO = pathlib.Path(__file__).resolve().parents[1]


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(j_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jit_init(jcfg):
    return jax.jit(lambda k: jM.init_params(jcfg, k))


def _params(jcfg, seed=0):
    jparams = _jit_init(jcfg)(jax.random.PRNGKey(seed))
    return jparams, interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """One reduced f32 config in both packages, the reference's params, the
    same params in the port, and (2, T) tokens."""
    jcfg, cfg = _cfgs(request.param)
    jparams, params = _params(jcfg)
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
    return 1e-4 * max(1.0, float(np.abs(want).max()))


def _layer_err(got, want):
    """The error and its bound, 1e-5 of max|want| with no floor: at the
    reduced widths the routed experts' outputs are of order 1e-2."""
    want = np.asarray(want)
    mag = float(np.abs(want).max())
    assert mag > 0
    return float(np.abs(got.numpy() - want).max()), LAYER_TOL * mag


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_the_reference(arch):
    for full in (True, False):
        j, t = j_get_config(arch), get_config(arch)
        if not full:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.family == "moe" and t.source
    assert get_config(arch.replace("_", "-")) is get_config(arch)


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_specs_match_the_reference(arch, full):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    if not full:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.active_param_count() < cfg.param_count()
    specs = _flat(M.build_param_specs(cfg))
    jspecs = _flat(jM.build_param_specs(jcfg))
    assert set(specs) == set(jspecs)
    for k, s in specs.items():
        assert (s.shape, s.axes, s.scale) == (jspecs[k].shape, jspecs[k].axes,
                                             jspecs[k].scale), k
    assert ("/layers/shared/w_up" in specs) == bool(cfg.n_shared_experts)
    assert ("/layers/dense/w_up" in specs) == cfg.dense_residual


def test_full_sizes():
    """The reference's counts at full width: Qwen1.5-MoE-A2.7B 14.32 B
    (2.69 B active), Arctic-480B 476.9 B."""
    qwen, arctic = get_config("qwen2_moe_a2_7b"), get_config("arctic_480b")
    assert 14.3e9 < qwen.param_count() < 14.35e9
    assert 2.68e9 < qwen.active_param_count() < 2.7e9
    assert 476e9 < arctic.param_count() < 477e9


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_match_the_reference(arch):
    """MoE families keep the GQA cache."""
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_caches_carry_across_exactly(arch, dtype):
    jcfg, _ = _cfgs(arch, dtype)
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
# routing and dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("logits,k", [
    ([0.5, 1.0, 1.0, 0.2, 1.0, 0.3], 2),  # torch.topk answers [2, 4]
    ([1.0, 1.0, 1.0, 1.0], 3),
    ([0.0, 2.0, 0.0, 2.0, 0.0, 0.0, 2.0, 0.0], 4),
    ([-1.0, -1.0, 3.0, -1.0, 3.0], 1),
], ids=["three-of-six", "all-equal", "three-way", "top1"])
def test_route_topk_ties_take_the_lower_index(logits, k):
    x = np.array([[logits, logits[::-1]]], np.float32)  # (1, 2, E)
    want_idx, want_w = jmoe.route_topk(jnp.asarray(x), k)
    idx, w = moe.route_topk(torch.tensor(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), atol=1e-7)
    assert w.dtype == torch.float32


def test_route_topk_matches_on_random_logits():
    x = np.random.default_rng(0).normal(0, 1, (3, 17, 60)).astype(np.float32)
    x[:, :, 7] = x[:, :, 3]  # a tie somewhere in most rows
    want_idx, want_w = jmoe.route_topk(jnp.asarray(x), 4)
    idx, w = moe.route_topk(torch.tensor(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), atol=1e-7)


@pytest.mark.parametrize("g,t,e,k,capacity", [
    (1, 16, 4, 2, 1),  # capacity 1: most claims dropped
    (3, 16, 8, 2, 3),  # several groups, some drops
    (2, 32, 8, 2, 8),  # the reduced configs' capacity (32*2//8)
    (2, 12, 6, 4, 8),  # top-4 of 6
    (2, 10, 4, 2, 20),  # room for every claim
], ids=["cap1", "groups3", "reduced", "top4", "nodrop"])
def test_dispatch_combine_is_exactly_the_reference(g, t, e, k, capacity):
    rng = np.random.default_rng(g * 100 + t)
    x = rng.normal(0, 1, (g, t, 8)).astype(np.float32)
    logits = rng.normal(0, 1, (g, t, e)).astype(np.float32)
    logits[..., 1] = logits[..., 0]  # ties
    idx, w = jmoe.route_topk(jnp.asarray(logits), k)
    want_d, want_c = jmoe.dispatch_combine(jnp.asarray(x), idx, w, e, capacity)
    got_d, got_c = moe.dispatch_combine(
        torch.tensor(x), torch.tensor(np.asarray(idx)).long(),
        torch.tensor(np.asarray(w)), e, capacity)
    assert tuple(got_d.shape) == (g, e, capacity, 8)
    assert tuple(got_c.shape) == (g, t, e, capacity)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    kept = int((got_c > 0).sum())
    if capacity >= t * k:
        assert kept == g * t * k  # room for every claim
    elif capacity == 1:
        assert kept <= g * e < g * t * k  # claims were dropped


def test_dispatch_combine_at_bfloat16_is_the_reference():
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (2, 16, 8)).astype(np.float32)
    logits = rng.normal(0, 1, (2, 16, 8)).astype(np.float32)
    idx, w = jmoe.route_topk(jnp.asarray(logits), 2)
    want_d, want_c = jmoe.dispatch_combine(jnp.asarray(x, jnp.bfloat16), idx,
                                           w, 8, 3)
    got_d, got_c = moe.dispatch_combine(
        torch.tensor(x).bfloat16(), torch.tensor(np.asarray(idx)).long(),
        torch.tensor(np.asarray(w)), 8, 3)
    assert got_d.dtype == got_c.dtype == torch.bfloat16
    for got, want in ((got_d, want_d), (got_c, want_c)):
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))


def _route(T, E, k, capacity, seed=0):
    """The reference invariants' inputs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(0, 1, (1, T, 8)), dtype=torch.float32)
    logits = torch.tensor(rng.normal(0, 1, (1, T, E)), dtype=torch.float32)
    idx, w = moe.route_topk(logits, k)
    disp, comb = moe.dispatch_combine(x, idx, w, E, capacity)
    return x, idx, w, disp, comb


@given(st.integers(8, 64), st.integers(2, 8), st.integers(1, 2),
       st.integers(0, 20))
@settings(max_examples=30, deadline=None)
def test_capacity_never_exceeded(T, E, k, seed):
    """Each (expert, slot) is claimed by at most one token: the combine
    tensor (G, T, E, C) has at most one nonzero along T per (e, c)."""
    cap = max(1, T * k // E)
    _, _, _, _, comb = _route(T, E, k, cap, seed)
    assert int((comb > 1e-9).sum(dim=1).max()) <= 1


@given(st.integers(8, 48), st.integers(2, 8), st.integers(1, 2),
       st.integers(0, 10))
@settings(max_examples=30, deadline=None)
def test_no_drops_means_exact_routing(T, E, k, seed):
    """With capacity >= T*k no claim is dropped: each token's combine
    weights sum to 1 (the softmax over its selected experts)."""
    x, _, _, disp, comb = _route(T, E, k, T * k, seed)
    np.testing.assert_allclose(comb.sum(dim=(2, 3)).numpy(), 1.0, atol=1e-5)
    # and every token sits in k slots of the dispatched buffers
    assert int((disp.abs().sum(-1) > 0).sum()) == T * k


def test_dropped_tokens_lose_weight():
    _, _, _, _, comb = _route(64, 2, 2, 1, seed=3)
    assert float(comb.sum(dim=(2, 3)).min()) < 0.999  # someone got dropped


# ---------------------------------------------------------------------------
# the MoE FFN and the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups,capacity_factor", [
    (1, 1.0), (2, 1.0), (4, 1.0), (2, 8.0), (1, 0.25)],
    ids=["g1", "g2", "g4", "nodrop", "cap-floor"])
def test_moe_ffn_matches_the_reference(groups, capacity_factor):
    jcfg, cfg = _cfgs("qwen2_moe_a2_7b")
    jparams, params = _params(jcfg)
    jp = jax.tree.map(lambda t: t[0], jparams["layers"]["moe"])
    p = tree_map(lambda t: t[0], params["layers"]["moe"])
    x = np.random.default_rng(2).normal(0, 1, (2, 32, cfg.d_model)).astype(
        np.float32)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              capacity_factor=capacity_factor, groups=groups)
    want_y, want_aux = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, **kw))(
        jp, jnp.asarray(x))
    y, aux = moe.moe_ffn(p, torch.tensor(x), **kw)
    err, tol = _layer_err(y, want_y)
    assert err <= tol
    assert abs(float(aux) - float(want_aux)) <= LAYER_TOL * max(
        1.0, abs(float(want_aux)))
    assert y.dtype == torch.float32 and aux.dtype == torch.float32


def test_moe_ffn_refuses_groups_that_do_not_divide():
    _, cfg = _cfgs("qwen2_moe_a2_7b")
    p = tree_map(lambda t: t[0],
                 M.init_params(cfg, 0, device="cpu")["layers"]["moe"])
    with pytest.raises(ValueError, match="do not split"):
        moe.moe_ffn(p, torch.zeros(1, 10, cfg.d_model), n_experts=cfg.n_experts,
                    top_k=cfg.top_k, groups=3)


@pytest.mark.parametrize("chunked", [False, True], ids=["dense", "chunked"])
def test_moe_layer_matches_the_reference(pair, chunked):
    """Qwen's shared experts, Arctic's dense residual MLP; 64 tokens in 2
    dispatch groups."""
    jcfg, cfg, jparams, params, _ = pair
    x = np.random.default_rng(5).normal(0, 1, (2, 32, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree.map(lambda t: t[1], jparams["layers"])
    p = tree_map(lambda t: t[1], params["layers"])
    jctx = jB.LayerCtx(mode="prefill", chunked=chunked)
    want, _, aux = jax.jit(lambda p, x: jB.moe_layer(jcfg, p, x, jctx))(
        jp, jnp.asarray(x))
    assert float(aux) > 0
    got, cache, got_aux = B.moe_layer(
        cfg, p, torch.tensor(x), B.LayerCtx(mode="prefill", chunked=chunked))
    assert cache is None
    err, tol = _layer_err(got, want)
    assert err <= tol
    # the load-balance aux that the training loss reads
    assert abs(float(got_aux) - float(aux)) <= 1e-5 * float(aux)


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


def test_forward_logits_match_the_reference(pair):
    jcfg, cfg, jparams, params, tokens = pair
    want = np.asarray(jax.jit(lambda p, t: jM.forward(jcfg, p, t)[0])(
        jparams, jnp.asarray(tokens)))
    got, caches = M.forward(cfg, params, torch.tensor(tokens))
    assert caches is None
    assert float(np.abs(got.numpy() - want).max()) <= _logit_bound(want)


def test_decode_steps_match_the_reference(pair):
    """Each step routes 2 tokens in one group at capacity 1: the same
    claims drop in both."""
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
        err = float(np.abs(got.numpy() - want).max())
        assert err <= _logit_bound(want), f"step {t}"
        for k in ("k", "v"):
            np.testing.assert_allclose(caches[k].numpy(),
                                       np.asarray(jcaches[k]), atol=LAYER_TOL,
                                       err_msg=f"{k} after step {t}")


def test_decode_matches_forward_without_drops(pair):
    """The port alone, as the reference's own
    ``test_moe_decode_matches_without_drops``: with ``capacity_factor = 8``
    no claim drops, so token-by-token decode reproduces the forward."""
    _, cfg, _, params, tokens = pair
    cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    full, _ = M.forward(cfg, params, torch.tensor(tokens))
    caches = S.init_caches(cfg, 2, T, device="cpu")
    for t in range(T):
        lg, caches = S.decode_step(cfg, params, torch.tensor(tokens[:, t:t + 1]),
                                   caches, t)
        want = full[:, t].numpy()
        assert float(np.abs(lg.numpy() - want).max()) <= _logit_bound(want), t


def test_bf16_forward_is_finite(pair):
    _, cfg, _, _, tokens = pair
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = M.init_params(cfg, 0, device="cpu")
    for chunked in (False, True):
        logits, _ = M.forward(cfg, params, torch.tensor(tokens[:, :PREFILL]),
                              chunked=chunked)
        assert logits.dtype == torch.bfloat16
        assert bool(torch.isfinite(logits.float()).all())


def test_loop_reference_matches_dispatch():
    """``chip_smoke.py``'s token-by-token loop (the routing rule written
    out: groups, token order then choice order, a counter per expert, a
    drop at capacity) against the port's dispatch on the CPU: the same
    dropped claims and outputs."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, cfg = _cfgs("qwen2_moe_a2_7b")
    p = tree_map(lambda t: t[0],
                 M.init_params(cfg, 1, device="cpu")["layers"]["moe"])
    rng = np.random.default_rng(3)
    xg = torch.tensor(rng.normal(0, 1, (3, 16, cfg.d_model)),
                      dtype=torch.float32)
    logits = torch.einsum("gtd,de->gte", xg, p["router"])
    idx, w = moe.route_topk(logits, cfg.top_k)
    capacity = 2
    want_y, want_dropped = smoke.moe_loop_reference(xg, idx, w, p, capacity)
    disp, comb = moe.dispatch_combine(xg, idx, w, cfg.n_experts, capacity)
    y = torch.einsum("gtec,gecd->gtd", comb, moe.experts(p, disp))
    assert smoke.dropped_claims(comb, idx) == want_dropped
    assert 0 < len(want_dropped) < idx.numel()
    err, mag = float((y - want_y).abs().max()), float(want_y.abs().max())
    assert mag > 0 and err <= LAYER_TOL * mag, (err, mag)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_returns_valid_tokens(arch):
    kw = dict(batch=2, prompt_len=4, new_tokens=5, reduced=True, device="cpu")
    gen, tps = serve(arch, **kw)
    cfg = get_config(arch).reduced()
    assert tuple(gen.shape) == (2, 5) and tps > 0
    assert int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab
    again, _ = serve(arch, **kw)
    assert torch.equal(gen, again)  # seeded


def test_serve_takes_a_config_cut_in_depth():
    """``serve`` of a config object: Arctic at its reduced widths cut to one
    layer, as the card serves it at full width."""
    cfg = dataclasses.replace(get_config("arctic_480b").reduced(), n_layers=1)
    gen, tps = serve(cfg, batch=2, prompt_len=3, new_tokens=4, reduced=False,
                     device="cpu")
    assert tuple(gen.shape) == (2, 4) and tps > 0
    assert int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_prints(arch, capsys):
    serve_main(["--arch", arch, "--batch", "2", "--tokens", "3",
                "--device", "cpu"])
    assert "generated (2, 3) tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_refuses_without_a_card(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--arch", arch, "--tokens", "2"])
