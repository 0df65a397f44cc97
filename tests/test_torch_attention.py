"""The port's attention, RoPE and SwiGLU blocks (``repro_torch.models.layers``)
on CPU tensors against the reference's ``repro.models.layers``, on the same
seeded numpy inputs in float32: ``dense_attention`` and
``chunked_attention`` causal, windowed (a window that masks whole rows of a
visited block), with ``kv_offset > 0`` (a cache prefix) and GQA with
``n_rep`` in {1, 2, 5}; ``_expand_kv`` as a repeat-interleave; ``apply_rope``
at float32 and bfloat16; ``swiglu``; ``gqa_attention`` without a cache,
chunked, and with a cache written in place at ``cache_index``; a decode
write at the cache's last slot as the reference's, and one past its end
refused with ``ValueError`` where the reference clamps it.

The outputs agree within 2e-5 of their magnitude (float32 sums in another
order; an indexing or masking error is of the output's own size), RoPE at
bfloat16 within one bfloat16 step.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = 2e-5


def _ref(fn, *args, **kw):
    """The reference's ``fn`` on ``args`` under ``jax.jit``, its keyword
    arguments static (one compile instead of an op-by-op dispatch)."""
    return jax.jit(functools.partial(fn, **kw))(*args)


def _close(got, want, tol=TOL):
    want = np.asarray(want, dtype=np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def _qkv(b, sq, skv, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, sq, h, d)).astype(np.float32),
            rng.normal(0, 1, (b, skv, hkv, d)).astype(np.float32),
            rng.normal(0, 1, (b, skv, hkv, d)).astype(np.float32))


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# (sq, skv, heads, kv heads): n_rep 1, 2 and 5 (Hymba's 25 / 5)
GQA = [(32, 32, 4, 4), (32, 32, 4, 2), (32, 32, 10, 2), (16, 48, 4, 2)]
MASKS = [dict(causal=True, window=0), dict(causal=True, window=8),
         dict(causal=False, window=0)]


def _gid(g):
    return f"sq{g[0]}-skv{g[1]}-rep{g[2] // g[3]}"


def _mid(m):
    return f"causal{int(m['causal'])}-w{m['window']}"


@pytest.mark.parametrize("mask", MASKS, ids=_mid)
@pytest.mark.parametrize("shape", GQA, ids=_gid)
def test_dense_attention_matches_the_reference(shape, mask):
    sq, skv, h, hkv = shape
    q, k, v = _qkv(2, sq, skv, h, hkv, 16, seed=sq + skv + h)
    q_offset = skv - sq
    want = _ref(jL.dense_attention, *_j(q, k, v), q_offset=q_offset, **mask)
    got = L.dense_attention(*_t(q, k, v), q_offset=q_offset, **mask)
    _close(got, want)


@pytest.mark.parametrize("mask", MASKS, ids=_mid)
@pytest.mark.parametrize("shape", GQA, ids=_gid)
def test_chunked_attention_matches_the_reference(shape, mask):
    """Chunks of 8: the window of 8 masks whole rows of the first block a
    q-chunk visits; skv > sq puts a cache prefix before the queries."""
    sq, skv, h, hkv = shape
    q, k, v = _qkv(2, sq, skv, h, hkv, 16, seed=sq * skv + h)
    kw = dict(q_chunk=8, kv_chunk=8, **mask)
    want = _ref(jL.chunked_attention, *_j(q, k, v), **kw)
    got = L.chunked_attention(*_t(q, k, v), **kw)
    assert bool(torch.isfinite(got).all())
    _close(got, want)
    # and the port's two dataflows agree with each other
    dense = L.dense_attention(*_t(q, k, v), q_offset=skv - sq, **mask)
    _close(got, dense.numpy())


@pytest.mark.parametrize("chunks", [(8, 16), (16, 8), (32, 32)],
                         ids=["q8-kv16", "q16-kv8", "one-block"])
def test_chunked_attention_with_unequal_chunks(chunks):
    q, k, v = _qkv(1, 32, 64, 6, 3, 8, seed=7)
    kw = dict(q_chunk=chunks[0], kv_chunk=chunks[1], window=12)
    _close(L.chunked_attention(*_t(q, k, v), **kw),
           _ref(jL.chunked_attention, *_j(q, k, v), **kw))


def test_chunked_attention_needs_a_uniform_grid():
    q, k, v = _t(*_qkv(1, 24, 24, 2, 2, 8, seed=0))
    with pytest.raises(ValueError, match="multiple of"):
        L.chunked_attention(q, k, v, q_chunk=16, kv_chunk=8)
    with pytest.raises(ValueError, match="multiple of"):
        L.chunked_attention(q, k, v, q_chunk=8, kv_chunk=16)


def test_neg_inf_is_finite():
    """A whole masked row of a visited block keeps the online softmax
    finite only with a finite NEG_INF (exp(m - m_new) = exp(0) there)."""
    assert L.NEG_INF == jL.NEG_INF == -1e30


@pytest.mark.parametrize("n_rep", [1, 2, 5])
def test_expand_kv_is_a_repeat_interleave(n_rep):
    k = np.random.default_rng(n_rep).normal(0, 1, (2, 5, 3, 4)).astype(
        np.float32)
    got = L._expand_kv(torch.tensor(k), n_rep)
    assert torch.equal(got, torch.repeat_interleave(torch.tensor(k), n_rep,
                                                    dim=2))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jL._expand_kv(jnp.asarray(k),
                                                           n_rep)))
    # query head h reads kv head h // n_rep
    for h in range(3 * n_rep):
        assert torch.equal(got[:, :, h], torch.tensor(k)[:, :, h // n_rep])


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_freqs_match_the_reference(theta):
    np.testing.assert_allclose(L.rope_freqs(64, theta).numpy(),
                               np.asarray(jL.rope_freqs(64, theta)),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 37])
def test_apply_rope_matches_the_reference(dtype, offset):
    """Halves rotated (not interleaved pairs), float32 angles, the result in
    x's type; at bfloat16 the float32 products round once, as in the
    reference, so the two agree within one bfloat16 step."""
    rng = np.random.default_rng(offset)
    x = rng.normal(0, 1, (2, 12, 3, 16)).astype(np.float32)
    pos = np.arange(12) + offset
    tx = torch.tensor(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = L.apply_rope(tx, torch.tensor(pos), 1e4)
    want = _ref(jL.apply_rope, jx, jnp.asarray(pos), theta=1e4)
    assert got.dtype == tx.dtype
    tol = TOL if dtype == "float32" else 2.0 ** -7
    _close(got, np.asarray(want.astype(jnp.float32)), tol)


def test_apply_rope_rotates_halves():
    """Position p rotates (x[i], x[i + D/2]) by p * freq[i]."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 1] = 1.0
    out = L.apply_rope(x, torch.tensor([3]), 1e4)
    ang = 3 * float(L.rope_freqs(8)[1])
    np.testing.assert_allclose(out[0, 0, 0, [1, 5]].numpy(),
                               [np.cos(ang), np.sin(ang)], rtol=1e-6)
    assert float(out[..., [0, 2, 3, 4, 6, 7]].abs().max()) == 0.0


def test_swiglu_matches_the_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 7, 16)).astype(np.float32)
    ws = [rng.normal(0, 0.3, s).astype(np.float32)
          for s in ((16, 40), (16, 40), (40, 16))]
    _close(L.swiglu(*_t(x, *ws)), _ref(jL.swiglu, *_j(x, *ws)))


def _gqa_params(d, h, hkv, dh, seed):
    rng = np.random.default_rng(seed)
    shapes = dict(wq=(d, h, dh), wk=(d, hkv, dh), wv=(d, hkv, dh),
                  wo=(h, dh, d))
    return {k: rng.normal(0, d ** -0.5, s).astype(np.float32)
            for k, s in shapes.items()}


GQA_KW = dict(n_heads=10, n_kv_heads=2, d_head=8, rope_theta=1e4)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("chunked", [False, True], ids=["dense", "chunked"])
def test_gqa_attention_without_a_cache(chunked, window):
    p = _gqa_params(24, 10, 2, 8, seed=window)
    x = np.random.default_rng(9).normal(0, 1, (2, 32, 24)).astype(np.float32)
    kw = dict(GQA_KW, window=window, chunked=chunked, q_chunk=8, kv_chunk=8)
    want, wc = _ref(jL.gqa_attention, {k: jnp.asarray(v) for k, v in
                                       p.items()}, jnp.asarray(x), **kw)
    got, gc = L.gqa_attention({k: torch.tensor(v) for k, v in p.items()},
                              torch.tensor(x), **kw)
    assert wc is None and gc is None
    _close(got, want)


@pytest.mark.parametrize("window", [0, 8])
def test_gqa_attention_with_a_cache(window):
    """Decode: 20 tokens one at a time, each written into the cache in
    place at its ``cache_index``; every step's output and the caches
    against the reference's."""
    p = _gqa_params(24, 10, 2, 8, seed=1)
    x = np.random.default_rng(2).normal(0, 1, (2, 20, 24)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jcache = {"k": jnp.zeros((2, 24, 2, 8)), "v": jnp.zeros((2, 24, 2, 8))}
    cache = {"k": torch.zeros(2, 24, 2, 8), "v": torch.zeros(2, 24, 2, 8)}
    kw = dict(GQA_KW, window=window)
    step = jax.jit(lambda x, c, i: jL.gqa_attention(jp, x, kv_cache=c,
                                                    cache_index=i, **kw))
    for t in range(20):
        want, jcache = step(jnp.asarray(x[:, t:t + 1]), jcache, jnp.int32(t))
        k_before = cache["k"]
        got, new = L.gqa_attention(tp, torch.tensor(x[:, t:t + 1]),
                                   kv_cache=cache, cache_index=t, **kw)
        assert new["k"] is k_before and new["v"] is cache["v"]  # in place
        _close(got, want)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])
    # the decode outputs reproduce the full causal forward
    full, _ = L.gqa_attention(tp, torch.tensor(x), **kw)
    _close(got[:, 0], full[:, -1].numpy())


def _fill_cache(p, n, seed):
    """A (2, n, 2, 8) GQA cache filled by n decode steps in the port, and
    the reference's cache after the same steps."""
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    x = np.random.default_rng(seed).normal(0, 1, (2, n, 24)).astype(
        np.float32)
    jcache = {"k": jnp.zeros((2, n, 2, 8)), "v": jnp.zeros((2, n, 2, 8))}
    cache = {"k": torch.zeros(2, n, 2, 8), "v": torch.zeros(2, n, 2, 8)}
    for t in range(n - 1):
        _, jcache = _ref(jL.gqa_attention, jp, jnp.asarray(x[:, t:t + 1]),
                         kv_cache=jcache, cache_index=t, **GQA_KW)
        L.gqa_attention(tp, torch.tensor(x[:, t:t + 1]), kv_cache=cache,
                        cache_index=t, **GQA_KW)
    return jp, tp, jcache, cache, x


def test_gqa_decode_writes_the_last_slot():
    """The step at ``cache_index = S_max - 1`` lands in the last slot, its
    output and the whole cache as the reference's."""
    p = _gqa_params(24, 10, 2, 8, seed=3)
    jp, tp, jcache, cache, x = _fill_cache(p, 8, 4)
    want, jcache = _ref(jL.gqa_attention, jp, jnp.asarray(x[:, 7:]),
                        kv_cache=jcache, cache_index=7, **GQA_KW)
    assert not cache["k"][:, 7].any()
    got, _ = L.gqa_attention(tp, torch.tensor(x[:, 7:]), kv_cache=cache,
                             cache_index=7, **GQA_KW)
    assert bool(cache["k"][:, 7].any()) and bool(cache["v"][:, 7].any())
    _close(got, want)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])


@pytest.mark.parametrize("index,s", [(8, 1), (7, 2), (20, 1)])
def test_gqa_decode_past_the_cache_raises(index, s):
    """A write of ``s`` positions at ``index`` into an 8-slot cache that
    would run past its end raises before anything is written (the
    reference's ``dynamic_update_slice`` clamps it onto the last slots and
    overwrites a live one; the port's slice would write nothing and drop
    the step's own K/V)."""
    p = _gqa_params(24, 10, 2, 8, seed=3)
    _, tp, _, cache, _ = _fill_cache(p, 8, 4)
    before = {k: v.clone() for k, v in cache.items()}
    x = torch.ones(2, s, 24)
    with pytest.raises(ValueError, match="past the cache"):
        L.gqa_attention(tp, x, kv_cache=cache, cache_index=index, **GQA_KW)
    for name in ("k", "v"):
        assert torch.equal(cache[name], before[name])
