"""The port's SSD chunk scan and Mamba-2 blocks on CPU tensors against the
reference, on the same numpy inputs.

``ssd_scan_plain`` (the CUDA kernel's plain version, which the wrapper runs
for CPU tensors) and ``ops.ssd_scan`` against the reference's Pallas
``ssd_scan_pallas`` in interpret mode, its ``ssd_ref`` recurrence and the
model's ``ssd_chunked``, and against the port's own ``ssd_ref`` and
``ssd_chunked``, within atol 5e-4 (the reference kernel tests' own);
bfloat16 inputs against the float32 recurrence within 0.05 max|y| (theirs
too).  Then ``ssd_chunked``, ``ssd_decode_step``, ``causal_conv1d`` and
``mamba2_mixer`` (prefill and decode) against the reference's, and the
mixer's prefill against itself with the port's ``ssd_chunked`` in the
kernel's place."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as j_ssd_ref  # noqa: E402
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as kd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from test_torch_cuda_ssd import cancelling_inputs  # noqa: E402

ATOL = 5e-4  # tests/test_ssd_kernel.py's


def _inputs(b, S, H, P, N, seed):
    """float32 numpy inputs by the reference kernel tests' recipe: dt =
    softplus(normal), A = -exp(normal(0, 0.5)), the rest standard
    normal."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (
        rng.normal(0, 1, (b, S, H, P)).astype(f),
        np.logaddexp(rng.normal(0, 1, (b, S, H)), 0).astype(f),
        -np.exp(rng.normal(0, 0.5, (H,))).astype(f),
        rng.normal(0, 1, (b, S, N)).astype(f),
        rng.normal(0, 1, (b, S, N)).astype(f),
        rng.normal(0, 1, (H,)).astype(f),
    )


def _t(args):
    return [torch.tensor(a) for a in args]


def _j(args):
    return [jnp.asarray(a) for a in args]


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_plain_matches_pallas_ref_and_chunked(chunk):
    args = _inputs(2, 64, 4, 8, 16, seed=chunk)
    y, st = kd.ssd_scan_plain(*_t(args), chunk=chunk)
    for ry, rst in (
        ssd_scan_pallas(*_j(args), chunk=chunk, interpret=True),
        j_ssd_ref(*_j(args)),
        jssm.ssd_chunked(*_j(args), chunk=chunk),
        ssd_ref(*_t(args)),
        ssm.ssd_chunked(*_t(args), chunk=chunk),
    ):
        _close(y, ry)
        _close(st, rst)
    oy, ost = ops.ssd_scan(*_t(args), chunk=chunk)
    assert torch.equal(oy, y) and torch.equal(ost, st)


@pytest.mark.parametrize("shape", [(1, 24, 2, 4, 8), (3, 40, 5, 16, 32)],
                         ids=["1x24x2x4x8", "3x40x5x16x32"])
def test_shape_sweep(shape):
    args = _inputs(*shape, seed=sum(shape))
    y, st = ops.ssd_scan(*_t(args), chunk=8)
    ry, rst = j_ssd_scan(*_j(args), chunk=8)
    _close(y, ry)
    _close(st, rst)
    _close(y, j_ssd_ref(*_j(args))[0])


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ragged_length_padded(chunk):
    """37 tokens: a trailing pad to the chunk grid whose dt = 0 leaves the
    final state exact."""
    args = _inputs(2, 37, 3, 8, 8, seed=37 + chunk)
    y, st = ops.ssd_scan(*_t(args), chunk=chunk)
    assert tuple(y.shape) == (2, 37, 3, 8)
    ry, rst = j_ssd_ref(*_j(args))
    _close(y, ry)
    _close(st, rst)
    py, pst = j_ssd_scan(*_j(args), chunk=chunk)
    _close(y, py)
    _close(st, pst)


def test_bf16_inputs():
    args = _inputs(1, 32, 2, 8, 8, seed=5)
    x, dt, A, B, C, D = _t(args)
    bf = torch.bfloat16
    y, _ = ops.ssd_scan(x.to(bf), dt, A, B.to(bf), C.to(bf), D, chunk=16)
    assert y.dtype == bf
    # the reference's own check: its f32 recurrence on the bf16 values
    f32_args = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                if i in (0, 3, 4) else a for i, a in enumerate(args)]
    ry, _ = j_ssd_ref(*_j(f32_args))
    scale = float(np.abs(np.asarray(ry)).max())
    err = float(np.abs(y.float().numpy() - np.asarray(ry)).max())
    assert err < 0.05 * scale


def test_port_ref_matches_reference_ref():
    args = _inputs(2, 20, 3, 4, 8, seed=9)
    y, st = ssd_ref(*_t(args))
    ry, rst = j_ssd_ref(*_j(args))
    _close(y, ry, 1e-5)
    _close(st, rst, 1e-5)


def test_wrapper_takes_the_plain_version_on_cpu_and_counts_nothing():
    args = _t(_inputs(1, 16, 2, 4, 8, seed=1))
    before = kd.SSD_SCAN.launches
    y, st = kd.ssd_scan_kernel(*args, chunk=8)
    py, pst = kd.ssd_scan_plain(*args, chunk=8)
    assert torch.equal(y, py) and torch.equal(st, pst)
    assert kd.SSD_SCAN.launches == before


@pytest.mark.parametrize("case", ["ragged", "mixed_dtype", "wide_head",
                                  "bad_shape"])
def test_wrapper_checks_its_arguments(case):
    x, dt, A, B, C, D = _t(_inputs(1, 16, 2, 4, 8, seed=2))
    chunk = 8
    if case == "ragged":
        chunk = 5
    elif case == "mixed_dtype":
        B = B.to(torch.bfloat16)
    elif case == "wide_head":
        x = torch.zeros((1, 16, 2, 65))
    else:
        A = A[:1]
    err = TypeError if case == "mixed_dtype" else ValueError
    with pytest.raises(err):
        kd.ssd_scan_kernel(x, dt, A, B, C, D, chunk=chunk)


def test_plain_tol_grows_by_a_bf16_step():
    ref = torch.tensor([3.0, -2.0])
    assert kd.plain_tol(ref, torch.float32) == pytest.approx(3e-4)
    assert kd.plain_tol(ref, torch.bfloat16) == pytest.approx(
        3 * (1e-4 + 2 ** -7))
    # relative all the way down: small states get small tolerances
    assert kd.plain_tol(ref * 1e-3, torch.float32) == pytest.approx(3e-7)


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


# bf16 parts of each float32 operand in the bf16 CUDA kernel's products:
# the masked, decayed, dt-scaled scores G, the carried state h_in, the
# state update's weighted x' = w x
KERNEL_PARTS = {"G": 2, "h_in": 2, "x'": 3}


def _emulate_split_kernel(x, dt, A, B, C, D, *, chunk, parts):
    """The bf16 CUDA kernel's arithmetic in plain float32 torch: x, B and C
    are bf16 values and enter their products exactly; each float32 operand
    goes in as ``parts[name]`` bf16 parts, bf16(v), then bf16 of what is
    left, and so on."""
    def split(v, name):
        out = []
        for _ in range(parts[name]):
            out.append(_bf16(v))
            v = v - out[-1]
        return out

    b, S, H, P = x.shape
    above = ~torch.ones((chunk, chunk), dtype=torch.bool).tril()
    h = torch.zeros((b, H, P, B.shape[-1]))
    ys = []
    for c0 in range(0, S, chunk):
        xk, dtk = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        Bk, Ck = B[:, c0:c0 + chunk], C[:, c0:c0 + chunk]
        cums = torch.cumsum(dtk * A, dim=1)  # (b,Q,H)
        seg = cums[:, :, None, :] - cums[:, None, :, :]  # (b,q,k,H)
        L = torch.exp(seg.masked_fill(above[None, :, :, None], float("-inf")))
        G = (Ck @ Bk.transpose(1, 2))[..., None] * L * dtk[:, None]
        y = sum(torch.einsum("bqkh,bkhp->bqhp", g, xk) for g in split(G, "G"))
        y = y + sum(torch.einsum("bqn,bhpn->bqhp", Ck, hp)
                    for hp in split(h, "h_in")) * torch.exp(cums)[..., None]
        ys.append(y + xk * D[:, None])
        w = torch.exp(cums[:, -1:] - cums) * dtk  # (b,Q,H)
        h = h * torch.exp(cums[:, -1])[..., None, None] + sum(
            torch.einsum("bqn,bqhp->bhpn", Bk, xp)
            for xp in split(xk * w[..., None], "x'"))
    return torch.cat(ys, dim=1), h


@pytest.mark.parametrize("passes", [1, 2], ids=["one_rounding", "hi_lo"])
def test_split_operands_and_the_state_tolerance(passes):
    """Why the kernel multiplies every float32 operand in more than one
    bf16 pass: one bf16 rounding of G, h_in and x' (2^-9 relative) breaks
    ``plain_tol`` on the state; the kernel's split (hi and lo of G and
    h_in, 2^-17; three parts of x') holds it, and y as well at the float32
    tolerance, on random inputs."""
    args = _t(_inputs(2, 128, 3, 16, 32, seed=11))
    x, dt, A, B, C, D = args
    x, B, C = _bf16(x), _bf16(B), _bf16(C)
    py, ps = kd.ssd_scan_plain(x, dt, A, B, C, D, chunk=32)
    parts = KERNEL_PARTS if passes == 2 else dict.fromkeys(KERNEL_PARTS, 1)
    ey, es = _emulate_split_kernel(x, dt, A, B, C, D, chunk=32, parts=parts)
    serr = float((es - ps).abs().max())
    stol = kd.plain_tol(ps, torch.float32)
    if passes == 1:
        assert serr > 2 * stol, (serr, stol)
    else:
        assert serr <= stol / 4, (serr, stol)
        yerr = float((ey - py).abs().max())
        assert yerr <= kd.plain_tol(py, torch.float32), yerr


def _split_case(case):
    """bf16-exact float32 inputs at a small size: the reference kernel
    tests' recipe (``"random"``, chunk 32) or the card tests'
    ``cancelling_inputs`` (``"keys"``, ``"state"``, chunk 32)."""
    if case == "random":
        x, dt, A, B, C, D = _t(_inputs(2, 128, 3, 16, 32, seed=11))
        return (_bf16(x), dt, A, _bf16(B), _bf16(C), D), 32
    return cancelling_inputs(case, 1, 64, 2, 8, 16), 32


def _split_errors(case, parts):
    """The emulated kernel's y (stored in bf16, as the kernel stores it)
    and state against the plain version's on bf16 inputs, each over its
    ``plain_tol``."""
    (x, dt, A, B, C, D), chunk = _split_case(case)
    bf = torch.bfloat16
    py, ps = kd.ssd_scan_plain(x.to(bf), dt, A, B.to(bf), C.to(bf), D,
                               chunk=chunk)
    ey, es = _emulate_split_kernel(x, dt, A, B, C, D, chunk=chunk,
                                   parts=parts)
    yerr = float((ey.to(bf).float() - py.float()).abs().max())
    serr = float((es - ps).abs().max())
    return (yerr / kd.plain_tol(py.float(), bf),
            serr / kd.plain_tol(ps, torch.float32))


@pytest.mark.parametrize("operand, parts, case, check", [
    ("G", 1, "keys", "y"), ("h_in", 1, "state", "y"),
    ("x'", 1, "random", "state"), ("x'", 2, "keys", "state")],
    ids=["G_once", "h_in_once", "x_once", "x_twice"])
def test_fewer_parts_of_one_operand_break_its_check(operand, parts, case,
                                                    check):
    """Each float32 operand needs the parts the kernel gives it: with the
    other two split as the kernel splits them, fewer parts of this one put
    y (G and h_in reach only y) or the state (x' reaches only the state)
    over twice ``plain_tol``; the card tests hold the kernel on the same
    inputs."""
    yratio, sratio = _split_errors(case, {**KERNEL_PARTS, operand: parts})
    assert (yratio if check == "y" else sratio) > 2, (yratio, sratio)


@pytest.mark.parametrize("case", ["random", "keys", "state"])
def test_the_kernels_split_holds_y_and_the_state(case):
    yratio, sratio = _split_errors(case, KERNEL_PARTS)
    assert yratio <= 1 and sratio <= 1, (yratio, sratio)


# ---------------------------------------------------------------------------
# models/ssm.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_ssd_chunked_matches(with_h0):
    args = _inputs(2, 24, 3, 4, 8, seed=11)
    h0 = (np.random.default_rng(3).normal(size=(2, 3, 4, 8))
          .astype(np.float32) if with_h0 else None)
    y, st = ssm.ssd_chunked(*_t(args), chunk=8,
                            h0=None if h0 is None else torch.tensor(h0))
    ry, rst = jssm.ssd_chunked(*_j(args), chunk=8,
                               h0=None if h0 is None else jnp.asarray(h0))
    _close(y, ry, 1e-5)
    _close(st, rst, 1e-5)


def test_segsum_matches():
    a = np.random.default_rng(4).normal(size=(2, 3, 7)).astype(np.float32)
    got = ssm._segsum(torch.tensor(a)).numpy()
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6)


def test_ssd_decode_step_matches():
    rng = np.random.default_rng(12)
    b, H, P, N = 2, 3, 4, 8
    f = np.float32
    state = rng.normal(size=(b, H, P, N)).astype(f)
    x = rng.normal(size=(b, H, P)).astype(f)
    dt = np.logaddexp(rng.normal(size=(b, H)), 0).astype(f)
    A = -np.exp(rng.normal(0, 0.5, H)).astype(f)
    B, C = (rng.normal(size=(b, N)).astype(f) for _ in range(2))
    D = rng.normal(size=H).astype(f)
    args = (state, x, dt, A, B, C, D)
    y, st = ssm.ssd_decode_step(*_t(args))
    ry, rst = jssm.ssd_decode_step(*_j(args))
    _close(y, ry, 1e-5)
    _close(st, rst, 1e-5)


@pytest.mark.parametrize("with_state", [False, True], ids=["pad", "state"])
def test_causal_conv1d_matches(with_state):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    s = rng.normal(size=(2, 3, 6)).astype(np.float32) if with_state else None
    y, ns = ssm.causal_conv1d(torch.tensor(x), torch.tensor(w),
                              state=None if s is None else torch.tensor(s))
    ry, rns = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                 state=None if s is None else jnp.asarray(s))
    _close(y, ry, 1e-6)
    _close(ns, rns, 0)


def _mixer_params(d, H, Pd, N, K, seed):
    rng = np.random.default_rng(seed)
    di = H * Pd
    f = np.float32
    return {
        "w_in": (rng.normal(size=(d, 2 * di + 2 * N + H)) / d ** 0.5).astype(f),
        "conv_w": (rng.normal(size=(K, di + 2 * N)) * 0.5).astype(f),
        "dt_bias": rng.normal(0, 0.1, H).astype(f),
        "A_log": rng.normal(0, 0.5, H).astype(f),
        "D": np.ones(H, f),
        "w_out": (rng.normal(size=(di, d)) / di ** 0.5).astype(f),
    }


@pytest.mark.parametrize("S", [13, 16])
def test_mamba2_mixer_prefill_and_decode_match(S):
    """Prefill (the port's SSD through ops.ssd_scan, the reference's through
    ssd_chunked) and then three decode steps from a cache."""
    d, H, Pd, N, K = 16, 3, 4, 8, 4
    kw = dict(n_heads=H, head_dim=Pd, state_dim=N, conv_dim=K, chunk=8)
    p = _mixer_params(d, H, Pd, N, K, seed=S)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x = np.random.default_rng(S + 1).normal(size=(2, S, d)).astype(np.float32)
    y, cache = ssm.mamba2_mixer(tp, torch.tensor(x), **kw)
    ry, rcache = jssm.mamba2_mixer(jp, jnp.asarray(x), **kw)
    assert cache is None and rcache is None
    _close(y, ry)
    rng = np.random.default_rng(S + 2)
    cache = {"conv": rng.normal(size=(2, K - 1, H * Pd + 2 * N)),
             "state": rng.normal(size=(2, H, Pd, N))}
    tc = {k: torch.tensor(v, dtype=torch.float32) for k, v in cache.items()}
    jc = {k: jnp.asarray(v, jnp.float32) for k, v in cache.items()}
    for t in range(3):
        xt = rng.normal(size=(2, 1, d)).astype(np.float32)
        y, tc = ssm.mamba2_mixer(tp, torch.tensor(xt), ssm_cache=tc, **kw)
        ry, jc = jssm.mamba2_mixer(jp, jnp.asarray(xt), ssm_cache=jc, **kw)
        _close(y, ry, 1e-5)
        for k in ("conv", "state"):
            _close(tc[k], jc[k], 1e-5)


@pytest.mark.parametrize("S", [13, 16])
def test_mamba2_mixer_prefill_matches_its_chunked_oracle(S, monkeypatch):
    """The port alone: the mixer's prefill through ``ops.ssd_scan`` against
    the same mixer with the port's ``ssd_chunked`` in the kernel's place
    (on the same padded chunk grid), the mixer's second oracle."""
    d, H, Pd, N, K = 16, 3, 4, 8, 4
    kw = dict(n_heads=H, head_dim=Pd, state_dim=N, conv_dim=K, chunk=8)
    tp = {k: torch.tensor(v) for k, v in _mixer_params(d, H, Pd, N, K, S).items()}
    x = torch.tensor(np.random.default_rng(S + 3).normal(size=(2, S, d)),
                     dtype=torch.float32)
    y, _ = ssm.mamba2_mixer(tp, x, **kw)
    monkeypatch.setattr(ops, "ssd_scan_kernel", ssm.ssd_chunked)
    want, _ = ssm.mamba2_mixer(tp, x, **kw)
    _close(y, want.numpy(), 1e-5)


def test_mixer_decode_takes_one_token():
    d, H, Pd, N, K = 16, 3, 4, 8, 4
    tp = {k: torch.tensor(v) for k, v in _mixer_params(d, H, Pd, N, K, 0).items()}
    cache = {"conv": torch.zeros(1, K - 1, H * Pd + 2 * N),
             "state": torch.zeros(1, H, Pd, N)}
    with pytest.raises(ValueError, match="one token"):
        ssm.mamba2_mixer(tp, torch.zeros(1, 2, d), n_heads=H, head_dim=Pd,
                         state_dim=N, ssm_cache=cache)

