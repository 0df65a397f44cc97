"""The port's online (MSDF) arithmetic and END against the reference's
``repro.core.online_arith`` / ``repro.core.end_detect`` on the same numpy
inputs: digits, adder-tree streams and END outputs exactly equal, decoded
values within 1e-6, ``EndStats`` fields equal."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import end_detect as jend  # noqa: E402
from repro.core import online_arith as joa  # noqa: E402
from repro_torch.core import end_detect as tend  # noqa: E402
from repro_torch.core import online_arith as toa  # noqa: E402


def _rng(seed):
    return np.random.default_rng(seed)


def _uniform(seed, shape, lo=-0.99, hi=0.99):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _dyadic(seed, shape, bits=10):
    """Values k / 2**bits in (-1, 1): every sum of a few products of them
    is exact in float32, whatever its order."""
    k = _rng(seed).integers(-(2 ** bits) + 1, 2 ** bits, shape)
    return (k / 2.0 ** bits).astype(np.float32)


def _t(a):
    """A torch copy of a numpy or jax array."""
    return torch.tensor(np.asarray(a))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


# (name, values): uniform floats, dyadic values, signed edge cases
VALUES = {
    "uniform": _uniform(1, (257,)),
    "dyadic": _dyadic(2, (3, 41)),
    "edges": np.float32([0.0, -0.0, 0.5, -0.5, 0.25, -0.75, 2.0 ** -20,
                         -(2.0 ** -20), 0.999, -0.999]),
}


@pytest.mark.parametrize("n", [1, 8, 16, 20])
@pytest.mark.parametrize("name", sorted(VALUES))
def test_to_digits_exact(name, n):
    x = VALUES[name]
    _eq(toa.to_digits(_t(x), n), joa.to_digits(jnp.asarray(x), n))


@pytest.mark.parametrize("n", [8, 20])
@pytest.mark.parametrize("name", sorted(VALUES))
def test_from_digits_and_prefixes(name, n):
    d = np.asarray(joa.to_digits(jnp.asarray(VALUES[name]), n))
    td = _t(d)
    np.testing.assert_allclose(toa.from_digits(td).numpy(),
                               np.asarray(joa.from_digits(jnp.asarray(d))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(toa.prefix_values(td).numpy(),
                               np.asarray(joa.prefix_values(jnp.asarray(d))),
                               atol=1e-6, rtol=0)


# (n_in, n_out): output streams longer than the input's, and as long as
# the delayed input (the reference pads with zeros only up to
# n_out + DELTA_OLM and rejects a longer input)
@pytest.mark.parametrize("n_in,n_out", [(16, 20), (12, 12), (12, 10)])
def test_online_mul_sp_exact(n_in, n_out):
    x, y = _uniform(3, (128,), -0.9, 0.9), _uniform(4, (128,), -0.9, 0.9)
    dx = np.asarray(joa.to_digits(jnp.asarray(x), n_in))
    _eq(toa.online_mul_sp(_t(dx), _t(y), n_out),
        joa.online_mul_sp(jnp.asarray(dx), jnp.asarray(y), n_out))


def test_online_mul_sp_broadcasts_y():
    """A (m,) weight row against (B, m, n) digit streams, as the WPU does."""
    x, y = _uniform(5, (6, 9), -0.9, 0.9), _uniform(6, (9,), -0.9, 0.9)
    dx = np.asarray(joa.to_digits(jnp.asarray(x), 12))
    _eq(toa.online_mul_sp(_t(dx), _t(y), 14),
        joa.online_mul_sp(jnp.asarray(dx), jnp.asarray(y), 14))


@pytest.mark.parametrize("scale_half", [True, False])
def test_online_add_exact(scale_half):
    a, b = _uniform(7, (128,), -0.9, 0.9), _uniform(8, (128,), -0.9, 0.9)
    if not scale_half:  # keep the unscaled sum inside (-1, 1)
        a, b = a / 2, b / 2
    da = np.asarray(joa.to_digits(jnp.asarray(a), 16))
    db = np.asarray(joa.to_digits(jnp.asarray(b), 16))
    _eq(toa.online_add(_t(da), _t(db),
                       scale_half=scale_half),
        joa.online_add(jnp.asarray(da), jnp.asarray(db), scale_half=scale_half))


@pytest.mark.parametrize("m", [1, 2, 9, 25])
def test_online_sop_tree_exact(m):
    x, y = _uniform(10 + m, (16, m), -0.9, 0.9), _uniform(20 + m, (16, m),
                                                          -0.9, 0.9)
    dx = np.asarray(joa.to_digits(jnp.asarray(x), 14))
    got, depth = toa.online_sop(_t(dx), _t(y), 18)
    want, jdepth = joa.online_sop(jnp.asarray(dx), jnp.asarray(y), 18)
    assert depth == jdepth
    _eq(got, want)


@pytest.mark.parametrize("m", [1, 9, 25])
def test_sop_digits_fast_exact(m):
    # dyadic operands: the sum of products is exact in either order
    x, y = _dyadic(30 + m, (64, m), 6), _dyadic(40 + m, (64, m), 6)
    got, depth = toa.sop_digits_fast(_t(x), _t(y),
                                     16)
    want, jdepth = joa.sop_digits_fast(jnp.asarray(x), jnp.asarray(y), 16)
    assert depth == jdepth
    _eq(got, want)


def _streams():
    """Digit streams END sees: encoded values (short and long, the long
    ones past the int32 clamp) and adder-tree SOP outputs."""
    x = _rng(50).normal(0, 0.3, (512,)).astype(np.float32).clip(-0.99, 0.99)
    tree_x = _uniform(51, (128, 9), -0.9, 0.9)
    tree_y = _uniform(52, (128, 9), -0.9, 0.9)
    tree, _ = joa.online_sop(joa.to_digits(jnp.asarray(tree_x), 12),
                             jnp.asarray(tree_y), 16)
    return {
        "encoded_t16": np.asarray(joa.to_digits(jnp.asarray(x), 16)),
        "encoded_t40": np.asarray(joa.to_digits(jnp.asarray(x), 40)),
        "tiny_negatives": np.asarray(joa.to_digits(
            jnp.asarray(np.float32([-(2.0 ** -20), -(2.0 ** -10), 0.0])), 16)),
        "sop_tree": np.asarray(tree),
    }


STREAMS = _streams()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_end_scan_exact(name):
    d = STREAMS[name]
    det, cyc = tend.end_scan(_t(d))
    jdet, jcyc = jend.end_scan(jnp.asarray(d))
    assert det.dtype == torch.bool and cyc.dtype == torch.int32
    _eq(det, jdet)
    _eq(cyc, jcyc)


def test_end_statistics_fields_equal():
    x = _rng(60).normal(0, 0.3, (2048,)).astype(np.float32).clip(-0.99, 0.99)
    d = np.asarray(joa.to_digits(jnp.asarray(x), 16))
    got = tend.end_statistics(_t(d), _t(x))
    want = jend.end_statistics(jnp.asarray(d), jnp.asarray(x))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("detected_frac", "undetermined_frac", "cycle_savings"):
        assert getattr(got, prop) == getattr(want, prop)
    assert got.detected > 0 and got.undetermined >= 0


def test_end_never_flags_nonnegative():
    """Algorithm 2's guarantee, on the port alone: a flagged stream is
    strictly negative."""
    x = _uniform(61, (4096,))
    det, _ = tend.end_scan(toa.to_digits(_t(x), 16))
    assert not bool((det & _t(x >= 0)).any())
