"""The port's digit-serial SOP + END path on CPU tensors (the kernel's plain
version) against the reference's Pallas ``online_sop_end`` in interpret mode
and its ``online_sop_end_ref`` oracle, on the same numpy inputs: sop within
atol 1e-5 (5e-2 for bf16 inputs), termination cycles and detected flags
exactly equal.  Also ``conv_windows`` and the whole VGG-16 block-1 slice
(windows -> SOP + END per filter) against the reference."""

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
