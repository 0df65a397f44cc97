"""The port's digit-serial SOP + END path on CPU tensors (the kernel's plain
version) against the reference's Pallas ``online_sop_end`` in interpret mode
and its ``online_sop_end_ref`` oracle, on the same numpy inputs: sop within
atol 1e-5 (5e-2 for bf16 inputs), termination cycles and detected flags
exactly equal.  A ``(F, m)`` ``y`` against ``jax.vmap`` of both over the
filters; the kernel's fixed-point limbs of ``y`` and a CPU emulation of its
integer digit sums and float64 latch.  Also ``conv_windows`` and the whole
VGG-16 block-1 slice (windows -> SOP + END per filter) against the
reference."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import executor as jex  # noqa: E402
from repro.core.cnn_models import VGG_FUSION as J_VGG  # noqa: E402
from repro.kernels.online_sop.ops import online_sop_end as j_sop_end  # noqa: E402
from repro.kernels.online_sop.ref import online_sop_end_ref as j_ref  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core.cnn_models import VGG_FUSION  # noqa: E402
from repro_torch.core.online_arith import to_digits  # noqa: E402
from repro_torch.kernels.online_sop import online_sop as tos  # noqa: E402
from repro_torch.kernels.online_sop import online_sop_end  # noqa: E402
from repro_torch.kernels.online_sop.ref import online_sop_end_ref  # noqa: E402

SOP_ATOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _operands(seed, batch, m):
    """The reference kernel tests' operands: |x| < 1/m, y scaled by m/8."""
    rng = np.random.default_rng(seed)
    x = (rng.uniform(-0.9, 0.9, batch + (m,)) / m).astype(np.float32)
    y = rng.uniform(-0.9, 0.9, (m,)).astype(np.float32) / max(1, m // 8)
    return x, y


def _check(port, ref, atol):
    sop, cyc, det = (t.numpy() for t in port)
    rsop, rcyc, rdet = (np.asarray(a) for a in ref)
    assert sop.shape == rsop.shape and cyc.dtype == np.int32
    np.testing.assert_allclose(sop, rsop.astype(np.float32), atol=atol,
                               rtol=0)
    np.testing.assert_array_equal(det, rdet)
    np.testing.assert_array_equal(cyc, rcyc)


@pytest.mark.parametrize("n_digits", [8, 12, 14, 16, 20])
@pytest.mark.parametrize("batch", [(7,), (3, 50)], ids=["b7", "b3x50"])
@pytest.mark.parametrize("m", [9, 25, 121, 363])
def test_matches_pallas_and_ref(m, batch, n_digits):
    x, y = _operands(1000 * m + n_digits + len(batch), batch, m)
    port = online_sop_end(torch.tensor(x), torch.tensor(y), n_digits)
    _check(port, j_sop_end(jnp.asarray(x), jnp.asarray(y), n_digits),
           SOP_ATOL["float32"])
    _check(port, j_ref(jnp.asarray(x), jnp.asarray(y), n_digits),
           SOP_ATOL["float32"])


@pytest.mark.parametrize("m", [9, 121])
def test_port_ref_matches_reference_ref(m):
    x, y = _operands(7 + m, (5, 40), m)
    port = online_sop_end_ref(torch.tensor(x), torch.tensor(y), 16)
    _check(port, j_ref(jnp.asarray(x), jnp.asarray(y), 16), SOP_ATOL["float32"])


def test_bfloat16_input():
    """bf16 operands are cast to float32 before the recurrence, as the
    reference's wrapper does."""
    rng = np.random.default_rng(3)
    x = (rng.uniform(-0.5, 0.5, (64, 25)) / 25).astype(np.float32)
    y = rng.uniform(-0.5, 0.5, (25,)).astype(np.float32) / 4
    jx, jy = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)
    ty = torch.tensor(np.asarray(jy.astype(jnp.float32))).to(torch.bfloat16)
    port = online_sop_end(tx, ty, 12)
    _check(port, j_sop_end(jx, jy, 12), SOP_ATOL["bfloat16"])
    np.testing.assert_allclose(port[0].numpy(), (x * y).sum(-1),
                               atol=SOP_ATOL["bfloat16"])


def test_end_soundness_and_coverage():
    x, y = _operands(11, (2048,), 25)
    sop, cyc, det = online_sop_end(torch.tensor(x), torch.tensor(y), 16)
    assert not bool((det & (sop >= 0)).any())
    assert float(det[sop < -1e-3].float().mean()) > 0.95
    assert int(cyc.max()) <= 16 and int(cyc[~det].min()) == 16


def test_plain_margins_latch_first_nonpositive_cycle():
    x, y = _operands(12, (300,), 9)
    tx, ty = torch.tensor(x), torch.tensor(y)
    margins = tos.end_margins(tx, ty, 14)
    _, cyc, det = tos.online_sop_end_plain(tx, ty, 14)
    for r in range(300):
        hits = (margins[r] <= 0).nonzero()
        assert bool(det[r]) == (len(hits) > 0)
        assert int(cyc[r]) == (int(hits[0]) + 1 if len(hits) else 14)


def test_latch_disagreements_finds_changed_rows():
    x, y = _operands(13, (500,), 25)
    tx, ty = torch.tensor(x), torch.tensor(y)
    plain = tos.online_sop_end_plain(tx, ty, 16)
    rows, margins, tie = tos.latch_disagreements(tx, ty, 16, plain, plain)
    assert len(rows) == len(margins) == 0
    r = int(plain[2].nonzero()[0])  # a detected row, latched one cycle late
    got = (plain[0], plain[1].clone(), plain[2])
    got[1][r] += 1
    rows, margins, tie = tos.latch_disagreements(tx, ty, 16, got, plain)
    assert rows.tolist() == [r]
    want = tos.end_margins(tx, ty, 16)[r, int(plain[1][r]) - 1].abs()
    assert float(margins[0]) == float(want)
    assert tie == (25 + 16) * 2.0 ** -24 * float(ty.abs().sum())


def test_wrapper_contract():
    x = torch.zeros((4, 9))
    y = torch.zeros(9)
    before = tos.SOP_END.launches
    with pytest.raises(TypeError):
        tos.online_sop_end_kernel(x.double(), y, 8)
    with pytest.raises(ValueError):
        tos.online_sop_end_kernel(x, torch.zeros(8), 8)
    with pytest.raises(ValueError):
        tos.online_sop_end_kernel(x, y, 0)
    with pytest.raises(ValueError):
        tos.online_sop_end_kernel(torch.zeros((9, 4)).t(), y[:4], 8)
    with pytest.raises(ValueError):
        tos.online_sop_end_kernel(torch.zeros((4, 0)), torch.zeros(0), 8)
    with pytest.raises(RuntimeError, match="runs on CUDA"):
        tos.online_sop_end_kernel(x.to("meta"), y.to("meta"), 8)
    sop, cyc, det = tos.online_sop_end_kernel(x, y, 8)  # CPU: plain version
    assert sop.shape == cyc.shape == det.shape == (4,)
    assert tos.SOP_END.launches == before  # the plain version never counts


# ---------------------------------------------------------------------------
# a filter axis on y: the reference's jax.vmap written out
# ---------------------------------------------------------------------------


def _filters(seed, n_filters, m):
    """``n_filters`` weight vectors drawn like :func:`_operands`' ``y``."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.9, 0.9, (n_filters, m)) / max(1, m // 8)
            ).astype(np.float32)


@pytest.mark.parametrize("n_filters", [1, 3, 8])
@pytest.mark.parametrize("batch", [(7,), (3, 50)], ids=["b7", "b3x50"])
@pytest.mark.parametrize("m", [9, 25, 121, 363])
def test_filter_axis_matches_vmapped_pallas_and_ref(m, batch, n_filters):
    """``online_sop_end(x, Y (F, m))`` returns ``(..., F)``, column f equal
    to the reference on filter f: ``jax.vmap`` over ``Y`` with ``in_axes=0,
    out_axes=-1``, of the Pallas kernel (interpret mode) and of its oracle.
    Cycles and flags exactly equal; sop within ``SOP_ATOL`` (float32 sums of
    m products in another order)."""
    x, _ = _operands(2000 * m + n_filters + len(batch), batch, m)
    Y = _filters(3000 * m + n_filters, n_filters, m)
    port = online_sop_end(torch.tensor(x), torch.tensor(Y), 16)
    assert port[0].shape == batch + (n_filters,)
    jx, jY = jnp.asarray(x), jnp.asarray(Y)
    for fn in (j_sop_end, j_ref):
        ref = jax.vmap(lambda yy, fn=fn: fn(jx, yy, 16), in_axes=0,
                       out_axes=-1)(jY)
        _check(port, ref, SOP_ATOL["float32"])


def test_filter_axis_contract():
    x = torch.zeros((4, 9))
    with pytest.raises(ValueError):
        tos.online_sop_end_kernel(x, torch.zeros((3, 8)), 8)
    with pytest.raises(ValueError):
        tos.online_sop_end_kernel(x, torch.zeros((0, 9)), 8)
    with pytest.raises(ValueError):
        tos.online_sop_end_kernel(x, torch.zeros((2, 3, 9)), 8)
    with pytest.raises(ValueError):
        tos.online_sop_end_kernel(x, torch.zeros((9, 3)).t(), 8)
    sop, cyc, det = tos.online_sop_end_kernel(x, torch.zeros((5, 9)), 8)
    assert sop.shape == cyc.shape == det.shape == (4, 5)


def _limb_filters():
    """Random filters, an all-zero one, one whose max is an exact power of
    two (both signs), one just below a power of two, and tiny values."""
    rng = np.random.default_rng(31)
    y = rng.standard_normal((8, 40)).astype(np.float32) * 0.05
    y[1] = 0.0
    y[2, 5] = 0.25
    y[3, 7] = -2.0
    y[4] = np.float32(1.0) - np.float32(2.0 ** -24)  # max|y| just below 1
    y[5] *= np.float32(2.0 ** -130)  # subnormal
    y[6, ::2] = 0.0
    return torch.tensor(y)


def test_limb_split_is_exact_and_in_range():
    """q = round(y 2^(31-E)) with |q| <= 2^30 and |y - q 2^(E-31)| <=
    2^(E-32) (the rounding of one step); four balanced limbs in [-128, 127]
    whose weighted sum is q exactly (no tolerance: integers)."""
    y = _limb_filters()
    q, e = tos.quantise_filters(y)
    assert q.dtype == torch.int64 and int(q.abs().max()) <= 2 ** 30
    err = (y.double() - torch.ldexp(q.double(), (e - 31)[:, None])).abs()
    one = torch.ones(e.shape, dtype=torch.float64)
    assert bool((err <= torch.ldexp(one, e - 32)[:, None]).all())
    assert int(e[1]) == 0 and not bool(q[1].any())  # the all-zero filter
    # max|y| = 2^-2 and 2^1: E = ceil(log2 max) + 1, q reaches 2^30 exactly
    assert int(e[2]) == -1 and int(q[2].abs().max()) == 2 ** 30
    assert int(e[3]) == 2 and int(q[3].min()) == -2 ** 30
    assert int(e[4]) == 1 and int(q[4].max()) == 2 ** 30 - 2 ** 6
    limbs = tos.split_limbs(q)
    assert limbs.dtype == torch.int8 and limbs.shape == (4,) + tuple(y.shape)
    wide = limbs.to(torch.int64)
    assert int(wide.min()) >= -128 and int(wide.max()) <= 127
    back = sum(256 ** k * wide[k] for k in range(4))
    assert torch.equal(back, q)
    w = tos.prepare_weights(y)
    assert w.limbs.shape == (4, 64, 64)
    assert torch.equal(w.limbs[:, :8, :40], limbs)
    assert not bool(w.limbs[:, 8:].any()) and not bool(w.limbs[:, :, 40:].any())
    assert torch.equal(w.tail[:8], q.abs().sum(-1).double())


def _emulate_kernel(x, y, n_digits):
    """The CUDA kernel's END latch, emulated on the CPU from the wrapper's
    limbs: each limb's digit sum is an integer (float64 holds it exactly),
    the limbs combine into S_j, and the prefix runs chunk by chunk of 16
    cycles in float64 in the kernel's order: four lanes each sum 4
    consecutive cycles in order, an inclusive scan of the lanes' sums by
    offsets 1, 2 gives each lane the sum before it, and the carried prefix
    is added last.  Returns (cycle, detected), each (P, F)."""
    F, m = y.shape
    w = tos.prepare_weights(y)
    limbs = w.limbs[:, :F, :m].double()
    n_pad = -(-n_digits // 16) * 16
    d = to_digits(x, n_pad).double()  # (P, m, n_pad)
    per_limb = torch.einsum("pmj,lfm->lpfj", d, limbs)
    assert float(per_limb.abs().max()) <= 128 * 64 * -(-m // 64)
    s = (per_limb[0] + 256 * per_limb[1] + 65536 * per_limb[2]
         + 16777216 * per_limb[3])  # (P, F, n_pad), exact
    tail = w.tail[:F]
    carry = torch.zeros(s.shape[:2], dtype=torch.float64)
    cycle = torch.full(s.shape[:2], -1, dtype=torch.int32)
    for c0 in range(0, n_digits, 16):
        js = torch.arange(c0, c0 + 16)
        scale = torch.pow(2.0, -(js + 1).double())  # exact powers of two
        lp = (s[..., c0:c0 + 16] * scale).unflatten(-1, (4, 4)).clone()
        for b in range(1, 4):  # each lane's 4 cycles, in order
            lp[..., b] = lp[..., b] + lp[..., b - 1]
        inc = lp[..., 3]
        inc = torch.cat([inc[..., :1], inc[..., 1:] + inc[..., :-1]], -1)
        inc = torch.cat([inc[..., :2], inc[..., 2:] + inc[..., :-2]], -1)
        exc = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :3]], -1)
        pref = ((exc[..., None] + lp) + carry[..., None, None]).flatten(-2)
        fire = (pref + tail[:, None] * scale <= 0) & (js < n_digits)
        first = torch.where(fire.any(-1),
                            fire.to(torch.uint8).argmax(-1) + c0 + 1, -1)
        cycle = torch.where((cycle < 0) & (first > 0), first.int(), cycle)
        carry = pref[..., 15]
    detected = cycle > 0
    return torch.where(detected, cycle, n_digits), detected


@pytest.mark.parametrize("level", [0, 1])
def test_kernel_latch_emulation_matches_plain(level):
    """The kernel's integer digit sums and float64 latch, emulated from the
    wrapper's limbs on CONV1 / CONV2 windows of the 32x32 VGG-16 (8 filters,
    16 and 24 digits), against the plain float32 version: cycles and flags
    equal except where the plain version's margin lies inside the band
    ``(m + n_digits) 2^-24 sum|y|`` of ``latch_disagreements`` (the plain
    version rounds its float32 sums; the emulation's sums are exact up to
    y's 2^-30 quantisation and float64 rounding)."""
    tp = tex.init_pyramid_params(VGG32, seed=1, device="cpu")
    x = torch.tensor(_image(9))
    if level == 1:
        conv1 = dataclasses.replace(VGG32, levels=VGG32.levels[:1])
        x = tex.reference_forward(x, conv1, tp)
    win, _ = tex.conv_windows(x, VGG32, level)
    win = torch.tensor(_pow2_scale(win[0].numpy()))
    w = tp.weights[level]
    Y = w.permute(3, 2, 0, 1).reshape(w.shape[-1], -1)[:8].contiguous()
    for n_digits in (16, 24):
        cyc, det = _emulate_kernel(win, Y, n_digits)
        assert 0 < int(det.sum()) < det.numel()
        for f in range(Y.shape[0]):
            plain = tos.online_sop_end_plain(win, Y[f], n_digits)
            got = (plain[0], cyc[:, f], det[:, f])
            rows, margins, tie = tos.latch_disagreements(
                win, Y[f], n_digits, got, plain)
            assert bool((margins <= tie).all()), (f, rows, margins, tie)


# ---------------------------------------------------------------------------
# conv_windows and the whole slice
# ---------------------------------------------------------------------------

J_VGG32 = dataclasses.replace(J_VGG, input_size=32)
VGG32 = dataclasses.replace(VGG_FUSION, input_size=32)


def _image(seed, c=3, n=32, batch=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, n, n, c)).astype(np.float32)


@pytest.mark.parametrize("max_windows", [None, 100], ids=["all", "sub100"])
@pytest.mark.parametrize("level", [0, 1])
def test_conv_windows_match_reference(level, max_windows):
    c = VGG32.levels[level].n_in
    x = _image(20 + level, c=c, batch=2)
    got, n = tex.conv_windows(torch.tensor(x), VGG32, level, max_windows)
    want, jn = jex.conv_windows(jnp.asarray(x), J_VGG32, level, max_windows)
    assert n == jn
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _pow2_scale(w: np.ndarray) -> np.ndarray:
    """Scale by one power of two so every |value| < 1 (exact, signs kept)."""
    e = int(np.floor(np.log2(np.abs(w).max()))) + 1
    return w * np.float32(2.0 ** -e)


def test_vgg_block1_slice_matches_reference():
    """CONV1 windows of the image and CONV2 windows of relu(CONV1), each
    package computing its own map and windows and scaling them by a power
    of two, through SOP + END for 4 filters per layer, from the reference's
    own params: cycles and flags exactly equal, sop within 1e-5."""
    jp = jex.init_pyramid_params(J_VGG32, jax.random.PRNGKey(0))
    tp = interop.pyramid_params_from_numpy(jp, device="cpu")
    x = _image(5)
    # relu(CONV1 + b1), the map CONV2's windows are cut from, in each package
    j_conv1 = dataclasses.replace(J_VGG32, levels=J_VGG32.levels[:1])
    t_conv1 = dataclasses.replace(VGG32, levels=VGG32.levels[:1])
    ja1 = jex.reference_forward(jnp.asarray(x), j_conv1, jp)
    ta1 = tex.reference_forward(torch.tensor(x), t_conv1, tp)
    detected = 0
    for level, jin, tin in ((0, jnp.asarray(x), torch.tensor(x)),
                            (1, ja1, ta1)):
        win, _ = tex.conv_windows(tin, VGG32, level)
        jwin, _ = jex.conv_windows(jin, J_VGG32, level)
        win, jwin = _pow2_scale(win[0].numpy()), _pow2_scale(np.asarray(jwin)[0])
        # HWIO -> (Cin, K, K, Cout): the windows' feature order
        w = tp.weights[level]
        w = w.permute(2, 0, 1, 3).reshape(-1, w.shape[-1])
        for f in range(4):
            y = w[:, f].contiguous()
            port = online_sop_end(torch.tensor(win), y, 16)
            ref = j_sop_end(jnp.asarray(jwin), jnp.asarray(y.numpy()), 16)
            _check(port, ref, SOP_ATOL["float32"])
            detected += int(port[2].sum())
    assert detected > 0
