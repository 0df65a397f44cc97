"""Kernel D's backward on CPU tensors: ``ssd_scan_bwd_plain`` (the CUDA
backward kernel's algorithm in plain PyTorch, which the wrapper runs for
CPU tensors) against autograd through ``ssd_scan_plain`` and against
``jax.vjp`` of the reference's ``ssd_chunked``, on the same numpy inputs;
the custom op ``repro_torch::ssd_scan_bwd`` on fake and meta tensors, its
FLOP formula and its DTensor sharding rule; the autograd Function on the
CPU.

Tolerances.  At float64 the plain backward and float64 autograd compute
the same function by different formulas: they agree to 1e-10 of each
gradient's magnitude, far below any wrong term.  At float32 the plain
backward's error against float64 autograd may be at most
``kd.f64_tol``: 4 times plain float32 autograd's own error on the same
inputs, plus 1e-6 (some eight float32 roundings) of the gradient's
magnitude, since both sum the same float32 terms in other orders.  Observed:
errors from 7e-8 to 1.3e-5 of the magnitude, at most 1.6 times
autograd's where that is above 2e-7 (and up to 5.5 times a smaller one,
which the floor covers).  Against the reference's ``ssd_chunked`` under
``jax.vjp`` (float32, its own order of sums) the gradients agree within
``JAX_RTOL`` (2e-5) of their magnitude, where the observed error is
under 2e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as kd  # noqa: E402
from test_torch_cuda_ssd import _slow_inputs, cancelling_inputs  # noqa: E402

NAMES = ("x", "dt", "A", "B", "C", "D")
F64_RTOL = 1e-10
JAX_RTOL = 2e-5
PARTS_RTOL = 1e-5


def _inputs(b, S, H, P, N, seed, decay="random"):
    """float64 numpy inputs by the reference kernel tests' recipe (dt =
    softplus(normal), A = -exp(normal(0, 0.5)), the rest standard normal)
    and upstream gradients for y and the state.  ``decay="slow"``: dt
    log-uniform in [1e-3, 0.1] and A from -0.01 to -1 across the heads
    (the state survives a chunk); ``"strong"``: A = -exp(normal(2, 0.5))
    (it is gone within a few tokens)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, S, H, P))
    dt = np.log1p(np.exp(rng.normal(0, 1, (b, S, H))))
    A = -np.exp(rng.normal(0, 0.5, (H,)))
    if decay == "slow":
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (b, S, H)))
        A = -np.logspace(-2, 0, H)
    elif decay == "strong":
        A = -np.exp(rng.normal(2, 0.5, (H,)))
    B = rng.normal(0, 1, (b, S, N))
    C = rng.normal(0, 1, (b, S, N))
    D = rng.normal(0, 1, (H,))
    gy = rng.normal(0, 1, (b, S, H, P))
    gs = rng.normal(0, 1, (b, H, P, N))
    return [x, dt, A, B, C, D], gy, gs


def _t(a, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _autograd(args, gy, gs, chunk, dtype):
    """Gradients of ``ssd_scan_plain`` at ``dtype`` by plain autograd; an
    input the loss does not reach (C and D when only the state does) gets
    zeros."""
    ins = [_t(a, dtype) for a in args]
    grads = ops.ssd_scan_vjp(ins, chunk, [True] * 6,
                             None if gy is None else _t(gy, dtype),
                             None if gs is None else _t(gs, dtype))
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, ins)]


def _plain(args, gy, gs, chunk, dtype):
    ins = [_t(a, dtype) for a in args]
    b, S, H, P = ins[0].shape
    gy = torch.zeros_like(ins[0]) if gy is None else _t(gy, dtype)
    gs = (torch.zeros((b, H, P, ins[3].shape[-1]), dtype=dtype)
          if gs is None else _t(gs, dtype))
    return kd.ssd_scan_bwd_plain(*ins, gy, gs, chunk=chunk)


def _rel(got, want):
    """Max abs error over the reference's max magnitude; where the
    reference is all zeros, the error itself (which must then be 0)."""
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.abs().max())
    return err / scale if scale else err


def _check_f32(got, plain32, want64):
    """Each gradient's float32 error against float64 within
    ``kd.f64_tol`` of plain float32 autograd's own."""
    for name, g, a, w in zip(NAMES, got, plain32, want64):
        assert g is not None, f"no gradient for {name}"
        assert g.shape == w.shape, name
        err = float((g.double() - w.double()).abs().max())
        own = float((a.double() - w.double()).abs().max())
        limit = kd.f64_tol(own, float(w.abs().max()))
        assert err <= limit, (name, err, limit)


CASES = {
    # (b, S, H, P, N), chunk, decay, gy given, gstate given
    "random": ((2, 32, 3, 8, 4), 8, "random", True, True),
    "no_gstate": ((2, 32, 3, 8, 4), 8, "random", True, False),
    "gy_none": ((2, 32, 3, 8, 4), 8, "random", False, True),
    "n16": ((2, 64, 3, 16, 16), 16, "random", True, True),
    "p24_one_chunk": ((1, 24, 2, 24, 8), 24, "random", True, True),
    "slow": ((2, 96, 4, 16, 16), 32, "slow", True, True),
    "strong": ((2, 48, 3, 8, 8), 16, "strong", True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_float64_autograd(case):
    shape, chunk, decay, with_gy, with_gs = CASES[case]
    args, gy, gs = _inputs(*shape, seed=len(case), decay=decay)
    gy = gy if with_gy else None
    gs = gs if with_gs else None
    want = _autograd(args, gy, gs, chunk, torch.float64)
    # the algorithm itself, at float64
    for name, g, w in zip(NAMES, _plain(args, gy, gs, chunk, torch.float64),
                          want):
        assert g.dtype == torch.float64, name
        assert _rel(g, w) <= F64_RTOL, (name, _rel(g, w))
    got = _plain(args, gy, gs, chunk, torch.float32)
    assert all(g.dtype == torch.float32 for g in got)
    _check_f32(got, _autograd(args, gy, gs, chunk, torch.float32), want)


def test_the_decay_cases_decay_as_named():
    """The slow case carries over 5 % of the state across a chunk in most
    heads; the strong case keeps under 1e-6 of it."""
    for decay, test in (("slow", lambda m: m > 0.05),
                        ("strong", lambda m: m < 1e-6)):
        shape, chunk = CASES[decay][:2]
        args, _, _ = _inputs(*shape, seed=len(decay), decay=decay)
        b, S, H = shape[:3]
        dt, A = args[1], args[2]
        per_chunk = np.exp((dt * A).reshape(b, S // chunk, chunk, H).sum(2))
        assert test(float(np.median(per_chunk))), decay


def _padded(fn, args, chunk):
    """``fn`` (an SSD of whole chunks) behind ``ops.ssd_scan``'s padding."""
    x, dt, A, B, C, D = args
    S = x.shape[1]
    pad = (-S) % chunk

    def p(t):
        return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

    y, state = fn(p(x), p(dt), A, p(B), p(C), D, chunk=chunk)
    return y[:, :S], state


def _grads(fn, args, gy, gs, dtype):
    ins = [_t(a, dtype).requires_grad_() for a in args]
    y, state = fn(ins)
    return torch.autograd.grad((y, state), ins, (_t(gy, dtype), _t(gs, dtype)))


def test_function_through_the_pad_against_float64_autograd():
    """S = 27 pads to 32 at chunk 8: the Function's gradients (the plain
    backward on the CPU) within the float32 bound of float64 autograd
    through the same padding, and no kernel launch counted."""
    args, gy, gs = _inputs(2, 27, 3, 8, 16, seed=5)
    before = [k.launches for k in build.KERNELS]
    got = _grads(lambda a: ops.ssd_scan(*a, chunk=8), args, gy, gs,
                 torch.float32)
    assert [k.launches for k in build.KERNELS] == before

    def plain(a):
        return _padded(kd.ssd_scan_plain, a, 8)

    want = _grads(plain, args, gy, gs, torch.float64)
    _check_f32(got, _grads(plain, args, gy, gs, torch.float32), want)


def test_function_takes_the_plain_backward_on_the_cpu():
    """The Function's backward on CPU tensors is ``ssd_scan_bwd_plain``
    itself (bit for bit), and neither kernel counts a launch; inputs that
    want no gradient get None."""
    args, gy, gs = _inputs(1, 16, 2, 4, 8, seed=3)
    ins = [_t(a, torch.float32) for a in args]
    ins[0].requires_grad_()
    ins[3].requires_grad_()
    before = (kd.SSD_SCAN.launches, kd.SSD_SCAN_BWD.launches)
    y, state = ops.ssd_scan(*ins, chunk=8)
    gx, gB = torch.autograd.grad((y, state), (ins[0], ins[3]),
                                 (_t(gy, torch.float32),
                                  _t(gs, torch.float32)))
    assert (kd.SSD_SCAN.launches, kd.SSD_SCAN_BWD.launches) == before
    want = kd.ssd_scan_bwd_plain(*(t.detach() for t in ins),
                                 _t(gy, torch.float32), _t(gs, torch.float32),
                                 chunk=8)
    assert torch.equal(gx, want[0]) and torch.equal(gB, want[3])


def test_function_returns_gradients_in_the_inputs_types():
    """bf16 x, B, C with a bf16 dt and f32 A, D (the model's types): each
    gradient in its input's type, and within bf16 rounding of the float32
    plain backward on the same (bf16-exact) values."""
    args, gy, gs = _inputs(2, 32, 3, 8, 8, seed=4)
    bf = torch.bfloat16
    types = (bf, bf, torch.float32, bf, bf, torch.float32)
    ins = [_t(a, t).requires_grad_() for a, t in zip(args, types)]
    y, state = ops.ssd_scan(*ins, chunk=8)
    got = torch.autograd.grad((y, state), ins,
                              (_t(gy, bf), _t(gs, torch.float32)))
    want = kd.ssd_scan_bwd_plain(*(t.detach().float() for t in ins),
                                 _t(gy, bf).float(), _t(gs, torch.float32),
                                 chunk=8)
    for name, g, w, t in zip(NAMES, got, want, types):
        assert g.dtype == t, name
        # one rounding to bf16 (2^-8 relative) where the gradient is bf16
        tol = (2.0 ** -8 if t == bf else 1e-6) * float(w.abs().max())
        assert float((g.float() - w).abs().max()) <= tol, name


@pytest.mark.parametrize("case", ["random", "slow"])
def test_plain_backward_matches_jax_vjp_of_ssd_chunked(case):
    """float32 numpy inputs through the reference's ``ssd_chunked`` under
    ``jax.vjp`` and through ``ssd_scan_bwd_plain``: every gradient within
    ``JAX_RTOL`` of its magnitude."""
    shape, chunk, decay = CASES[case][:3]
    args, gy, gs = _inputs(*shape, seed=11, decay=decay)
    f32 = [np.asarray(a, np.float32) for a in args]
    y, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, chunk=chunk),
                     *[jnp.asarray(a) for a in f32])
    want = vjp((jnp.asarray(gy, jnp.float32), jnp.asarray(gs, jnp.float32)))
    got = _plain(args, gy, gs, chunk, torch.float32)
    for name, g, w in zip(NAMES, got, want):
        w = torch.from_numpy(np.array(w))
        assert _rel(g, w) <= JAX_RTOL, (name, _rel(g, w))


def test_bwd_op_traces_on_fake_and_meta_tensors():
    """The op's fake implementation: each gradient shaped and typed as
    its input after ``prepare``, with no launch; its FLOP formula, also
    as ``FlopCounterMode`` counts it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    b, S, H, P, N = 2, 16, 4, 8, 8
    for mode in (FakeTensorMode(), None):
        dev = "cpu" if mode is not None else "meta"
        with (mode or torch.device("meta")):
            x = torch.empty(b, S, H, P, dtype=torch.bfloat16, device=dev)
            dt = torch.empty(b, S, H, dtype=torch.bfloat16, device=dev)
            A, D = torch.empty(H, device=dev), torch.empty(H, device=dev)
            B = torch.empty(b, S, N, dtype=torch.bfloat16, device=dev)
            got = kd.ssd_scan_bwd_kernel(x, dt, A, B, B, D, x, None, chunk=8)
        for g, t, dtype in zip(got, (x, dt, A, B, B, D),
                               (torch.bfloat16, torch.float32, torch.float32,
                                torch.bfloat16, torch.bfloat16,
                                torch.float32)):
            assert tuple(g.shape) == tuple(t.shape) and g.dtype == dtype
    T = 8 * 9 // 2
    want = 2 * b * (S // 8) * (3 * T * N + H * (3 * T * P + 6 * 8 * P * N))
    assert kd.ssd_scan_bwd_flops((b, S, H, P), (b, S, N), 8) == want
    with FakeTensorMode():
        x = torch.empty(b, S, H, P)
        dt, A, D = torch.empty(b, S, H), torch.empty(H), torch.empty(H)
        B = torch.empty(b, S, N)
        with FlopCounterMode(display=False) as fc:
            kd.ssd_scan_bwd_kernel(x, dt, A, B, B, D, x, None, chunk=8)
    assert fc.get_total_flops() == want


def test_liveness_holds_the_backward_workspace_while_the_op_runs(
        monkeypatch):
    """The dry run's liveness walk adds D's backward's workspace
    (cumulative decays, entry states and exit adjoints in float32 and as
    bf16 parts, scores and their head sums on 64 x 64 tiles, partial sums)
    at the op's node, and only there; here, where that workspace is the
    largest buffer, the peak rises by exactly its size, which
    ``ssd_scan_bwd_workspace_bytes`` gives as the kernel lays it out."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from repro_torch.launch import graphanalysis as GA

    b, S, H, P, N, Q = 2, 32, 4, 8, 16, 8
    args, gy, _ = _inputs(b, S, H, P, N, seed=4)
    ins = [_t(a, torch.float32) for a in args] + [_t(gy, torch.float32)]

    def bwd(x, dt, A, B, C, D, gy):
        return kd.ssd_scan_bwd_kernel(x, dt, A, B, C, D, gy, None, chunk=Q)

    g = make_fx(bwd, tracing_mode="fake")(*ins)
    nc = S // Q
    units = b * nc * H
    f32 = b * S * H + 2 * units * P * N + 2 * b * nc * 64 * 64 + 2 * units
    # the bf16 instance's sections: <dh, h_in>'s partial sums (the scan's
    # eight warps: one block of 256 threads, two elements each), the
    # carried term (one 128-column pass), the states' three bf16 parts
    # twice; the dC/dB partial sums (4 groups x 2 x b S N) fit in the
    # float32 states' room
    assert 4 * 2 * b * S * N <= 2 * units * P * N
    ws = 4 * (f32 + 8 * units + b * S * H + 2 * 3 * units * P * N // 2)
    assert kd.ssd_scan_bwd_workspace_bytes((b, S, H, P), (b, S, N), Q) == ws
    assert [GA.scratch_bytes(n) for n in g.graph.nodes
            if GA.scratch_bytes(n)] == [ws]
    peak = GA.peak_live_bytes(g)
    monkeypatch.setattr(GA, "scratch_bytes", lambda node: 0)
    assert peak == GA.peak_live_bytes(g) + ws


@pytest.fixture
def mesh4():
    from repro_torch.launch.mesh import fake_mesh

    return fake_mesh((2, 2), ("data", "model"))


def test_bwd_op_sharding_rule_runs_each_shard_locally(mesh4):
    """Batch-sharded on one mesh dim and head-sharded on the other: rank
    0's gradients are the plain backward's on its batch and head block,
    dA and dD partial over the batch, dB and dC partial over the heads."""
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)

    kd.register_sharding_rule()
    args, gy, gs = _inputs(4, 16, 4, 8, 8, seed=2)
    ins = [_t(a, torch.float32) for a in args]
    gy, gs = _t(gy, torch.float32), _t(gs, torch.float32)
    R = Replicate()
    pl = {"x": [Shard(0), Shard(2)], "dt": [Shard(0), Shard(2)],
          "A": [R, Shard(0)], "B": [Shard(0), R], "C": [Shard(0), R],
          "D": [R, Shard(0)], "gy": [Shard(0), Shard(2)],
          "gs": [Shard(0), Shard(1)]}
    dist = [distribute_tensor(t, mesh4, pl[k]) for k, t in
            zip(NAMES + ("gy", "gs"), ins + [gy, gs])]
    got = kd.ssd_scan_bwd_kernel(*dist, chunk=8)
    S0, S2, Sum = Shard(0), Shard(2), Partial()
    assert [tuple(g.placements) for g in got] == [
        (S0, S2), (S0, S2), (Sum, S0), (S0, Sum), (S0, Sum), (Sum, S0)]
    local = [ins[0][:2, :, :2], ins[1][:2, :, :2], ins[2][:2], ins[3][:2],
             ins[4][:2], ins[5][:2]]
    want = kd.ssd_scan_bwd_plain(*local, gy[:2, :, :2], gs[:2, :2], chunk=8)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g.to_local(), w, rtol=1e-6, atol=1e-6,
                                   msg=name)


def _parts(t, k):
    """``t`` rounded to its first ``k`` bf16 parts (hi = bf16(t), then the
    remainders), as the bf16 backward kernel cuts a float32 operand."""
    out, rest = torch.zeros_like(t), t
    for _ in range(k):
        part = rest.to(torch.bfloat16).float()
        out, rest = out + part, rest - part
    return out


def _bwd_with_parts(x, dt, A, B, C, D, gy, gs, *, chunk, state_parts,
                    g_parts, carried="dc", dc_parts=3, db_parts=2,
                    m_parts=2):
    """``(dx, ddt, dB, dC)`` by ``ssd_scan_bwd_plain``'s algorithm with the
    bf16 kernels' cut.  The scan cuts the entry states and exit adjoints
    once; the chunk kernel multiplies dh in ``state_parts`` (dh B), G^T in
    ``g_parts`` (G^T dy, from registers).  The carried state's term of
    dcums is ``exp(cums) C . (h_in^T dy)`` from dC's per-head state term,
    h_in in ``dc_parts`` (``carried="dc"``, the dC kernel's), or
    ``dy . exp(cums) h_in C`` with h_in in ``state_parts`` (``"y"``, a
    product of its own).  dC's state term takes h_in in ``dc_parts``,
    dB's dh in ``db_parts``, M's products M in ``m_parts``."""
    b, S, H, P = x.shape
    N, Q = B.shape[-1], chunk
    nc = S // Q
    x, B, C, dy = (t.float().reshape(b, nc, Q, *t.shape[2:])
                   for t in (x, B, C, gy))
    dt = dt.reshape(b, nc, Q, H)
    cums = torch.cumsum(dt * A, 2)
    cl = cums[:, :, -1]
    xb = x * dt[..., None]
    w, ec = torch.exp(cl[:, :, None] - cums), torch.exp(cums)
    own = torch.einsum("bckhp,bckn->bchpn", xb * w[..., None], B)
    adj = torch.einsum("bcqhp,bcqn->bchpn", dy * ec[..., None], C)
    h_in, dh = torch.empty_like(own), torch.empty_like(adj)
    h, d = torch.zeros(b, H, P, N), gs.clone()
    for c in range(nc):
        h_in[:, c], h = h, torch.exp(cl[:, c])[..., None, None] * h + own[:, c]
    for c in reversed(range(nc)):
        dh[:, c], d = d, torch.exp(cl[:, c])[..., None, None] * d + adj[:, c]
    above = ~torch.ones(Q, Q, dtype=torch.bool).tril()
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    for c in range(nc):
        cq, xk, xbk, dyk, Bk, Ck = cums[:, c], x[:, c], xb[:, c], dy[:, c], \
            B[:, c], C[:, c]
        dhk = _parts(dh[:, c], state_parts)
        L = torch.exp((cq[:, :, None] - cq[:, None]).masked_fill(
            above[None, :, :, None], float("-inf")))
        G = L * (Ck @ Bk.transpose(1, 2))[..., None]
        v = torch.einsum("bhpn,bkn->bkhp", dhk, Bk)
        dxb = torch.einsum("bqkh,bqhp->bkhp", _parts(G, g_parts), dyk) + \
            w[:, c][..., None] * v
        dx[:, c] = dt[:, c][..., None] * dxb + D[:, None] * dyk
        dG = torch.einsum("bqhp,bkhp->bqkh", dyk, xbk)
        dGG = dG * G
        u = torch.einsum("bqhp,bhpn->bqhn", dyk, _parts(h_in[:, c], dc_parts))
        if carried == "dc":
            car = torch.einsum("bqn,bqhn->bqh", Ck, u) * ec[:, c]
        else:
            yo = torch.einsum("bqn,bhpn->bqhp", Ck,
                              _parts(h_in[:, c], state_parts))
            car = (dyk * yo).sum(-1) * ec[:, c]
        wdw = w[:, c] * (xbk * v).sum(-1)
        dcums = dGG.sum(2) - dGG.sum(1) + car - wdw
        dcums[:, -1] += wdw.sum(1) + torch.exp(cl[:, c]) * (
            dh[:, c] * h_in[:, c]).sum((-1, -2))
        ddt[:, c] = (xk * dxb).sum(-1) + A * dcums.flip(1).cumsum(1).flip(1)
        M = _parts((dG * L).sum(-1), m_parts)
        dC[:, c] = M @ Bk + torch.einsum("bqh,bqhn->bqn", ec[:, c], u)
        dB[:, c] = M.transpose(1, 2) @ Ck + torch.einsum(
            "bkh,bkhp,bhpn->bkn", w[:, c] * dt[:, c], xk,
            _parts(dh[:, c], db_parts))
    return (dx.reshape(b, S, H, P), ddt.reshape(b, S, H),
            dB.reshape(b, S, N), dC.reshape(b, S, N))


def _parts_inputs(case):
    """The card tests' inputs with bf16 x, B, C and a bf16 gy (chunk 256,
    the model's head and state), and a float32 gstate."""
    if case == "slow":
        raw = _slow_inputs(1, 1024, 5, torch.float32, seed=7)
    else:
        raw = cancelling_inputs(case, 1, 512, 2, 64, 128)
    x, dt, A, B, C, D = raw
    bf = torch.bfloat16
    args = [x.to(bf), dt, A, B.to(bf), C.to(bf), D]
    gen = torch.Generator().manual_seed(5)
    gy = torch.randn(x.shape, generator=gen).to(bf)
    gs = torch.randn((1, x.shape[2], 64, 128), generator=gen)
    return args, gy, gs


@pytest.mark.parametrize("case", ["keys", "state", "slow"])
def test_the_bf16_kernels_parts_hold_ddt_and_dx(case):
    """Three parts of the states and two of G (the bf16 kernel's cut) keep
    ddt and dx within ``PARTS_RTOL`` of their magnitude against the plain
    backward (observed: at most 1.4e-6); on the ``"state"`` inputs two
    parts of the states do not (3.9e-5), and on the ``"keys"`` inputs one
    part of G breaks even ``plain_tol``'s 1e-4 (6.8e-4)."""
    args, gy, gs = _parts_inputs(case)
    # the plain backward on the same (bf16-exact) values in float32, so
    # that dx is not rounded to bf16
    want = kd.ssd_scan_bwd_plain(*(t.float() for t in args), gy.float(), gs,
                                 chunk=256)
    dx, ddt = _bwd_with_parts(*args, gy, gs, chunk=256, state_parts=3,
                              g_parts=2, carried="y")[:2]
    assert _rel(ddt, want[1]) <= PARTS_RTOL, _rel(ddt, want[1])
    assert _rel(dx, want[0]) <= PARTS_RTOL, _rel(dx, want[0])
    if case == "state":
        ddt2 = _bwd_with_parts(*args, gy, gs, chunk=256, state_parts=2,
                               g_parts=2, carried="y")[1]
        assert _rel(ddt2, want[1]) > PARTS_RTOL, _rel(ddt2, want[1])
    if case == "keys":
        ddt1 = _bwd_with_parts(*args, gy, gs, chunk=256, state_parts=3,
                               g_parts=1, carried="y")[1]
        assert _rel(ddt1, want[1]) > 1e-4, _rel(ddt1, want[1])


@pytest.mark.parametrize("case", ["keys", "state", "slow"])
def test_the_wgmma_kernels_cut_holds_every_gradient(case):
    """The cut of the wgmma kernels: the states cut into three parts once,
    by the scan; the carried state's term of dcums taken from dC's
    per-head state term h_in^T dy (h_in in three parts) rather than from a
    product of its own; G^T's two parts as the register operand of
    G^T dy; M and dh in two parts for dC and dB.  On the cancelling and
    slowly decaying inputs ddt and dx stay within 1e-4 of their magnitude
    (``plain_tol``'s float32 share; observed: at most 1.4e-6), dB and dC
    too (at most 5.3e-6 and 5.4e-5, far inside the 2^-7 a bf16 dB or dC
    may take besides), and the carried term's new order moves ddt by less
    than ``PARTS_RTOL`` (at most 3.5e-8) against a product of its own."""
    args, gy, gs = _parts_inputs(case)
    want = kd.ssd_scan_bwd_plain(*(t.float() for t in args), gy.float(), gs,
                                 chunk=256)
    dx, ddt, dB, dC = _bwd_with_parts(*args, gy, gs, chunk=256,
                                      state_parts=3, g_parts=2)
    for name, got, w in (("ddt", ddt, want[1]), ("dx", dx, want[0]),
                         ("dB", dB, want[3]), ("dC", dC, want[4])):
        assert _rel(got, w) <= 1e-4, (name, _rel(got, w))
    ddt_y = _bwd_with_parts(*args, gy, gs, chunk=256, state_parts=3,
                            g_parts=2, carried="y")[1]
    assert _rel(ddt, ddt_y) <= PARTS_RTOL, _rel(ddt, ddt_y)
