"""The training path on the card: kernel D's autograd Function (the CUDA
forward and the CUDA backward kernel) against plain and float64 autograd
through ``ssd_scan_plain``, at float32 and bfloat16; the backward kernel
against its plain version ``ssd_scan_bwd_plain`` over shapes the tiling
must pad, on the cancelling and slowly decaying inputs of
``tests/test_torch_cuda_ssd.py`` and at Hymba's state of 16, two runs equal
bit for bit; a reduced-config train step on the card against the same
step on the CPU; D's and its backward's launch counts inside a train step
(a layer's forward and its remat recompute, and one backward, per
microbatch).

Every test here needs an NVIDIA card with nvcc and skips elsewhere.  Run on
the card with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda_train.py``.  This file imports no JAX.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_at  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as kd  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.models.params import leaves, tree_map  # noqa: E402
from test_torch_cuda_ssd import _slow_inputs, cancelling_inputs  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, S, H, P, N, dtype, seed, device):
    """The reference kernel tests' recipe: x, B and C in ``dtype``, dt, A
    and D in float32, on ``device``."""
    rng = np.random.default_rng(seed)
    f32 = torch.float32

    def t(a, dt=f32):
        return torch.tensor(a, dtype=f32).to(device=device, dtype=dt)

    x = t(rng.normal(0, 1, (b, S, H, P)), dtype)
    dt = torch.nn.functional.softplus(t(rng.normal(0, 1, (b, S, H))))
    A = -torch.exp(t(rng.normal(0, 0.5, (H,))))
    B = t(rng.normal(0, 1, (b, S, N)), dtype)
    C = t(rng.normal(0, 1, (b, S, N)), dtype)
    D = t(rng.normal(0, 1, (H,)))
    return [x, dt, A, B, C, D]


NAMES = ("x", "dt", "A", "B", "C", "D")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_function_grads_equal_plain_autograd(cuda, dtype):
    """One counted launch of D in the forward and one of its backward
    kernel in the backward; ``y`` carries autograd history and lies within
    ``plain_tol`` of the plain version; every input's gradient is present,
    in its input's type, within ``plain_tol`` (at that type) of
    ``ssd_scan_bwd_plain`` on the same inputs, and, against float64
    autograd through ``ssd_scan_plain`` on the same values, within 4
    times plain autograd's own error at the inputs' types plus 1e-6 of
    the gradient's magnitude (the same float32 terms in other orders, and
    the same one rounding of a bf16 gradient)."""
    args = _inputs(2, 512, 6, 64, 32, dtype, 0, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    gy = torch.randn(args[0].shape, generator=gen, device=cuda).to(dtype)
    gs = torch.randn((2, 6, 64, 32), generator=gen, device=cuda)
    fn_in = [t.clone().requires_grad_() for t in args]
    build.reset_launch_counts()
    y, state = ops.ssd_scan(*fn_in, chunk=256)
    assert (kd.SSD_SCAN.launches, kd.SSD_SCAN_BWD.launches) == (1, 0)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y, state), fn_in, (gy, gs))
    assert (kd.SSD_SCAN.launches, kd.SSD_SCAN_BWD.launches) == (1, 1)
    pl_in = [t.clone().requires_grad_() for t in args]
    py, ps = kd.ssd_scan_plain(*pl_in, chunk=256)
    own = torch.autograd.grad((py, ps), pl_in, (gy, gs))
    a64 = [t.double().requires_grad_() for t in args]
    y64, s64 = kd.ssd_scan_plain(*a64, chunk=256)
    want = torch.autograd.grad((y64, s64), a64, (gy.double(), gs.double()))
    pb = kd.ssd_scan_bwd_plain(*kd.prepare(*args, 256), gy, gs, chunk=256)
    with torch.no_grad():
        assert float((y.float() - py.float()).abs().max()) <= kd.plain_tol(
            py.float(), dtype)
        assert float((state - ps).abs().max()) <= kd.plain_tol(
            ps, torch.float32)
    for name, a, o, w, p, t in zip(NAMES, got, own, want, pb, args):
        assert a is not None, f"no gradient for {name}"
        assert a.dtype == t.dtype, name
        assert bool(torch.isfinite(a).all()), name
        err = float((a.float() - p.float()).abs().max())
        assert err <= kd.plain_tol(p.float(), a.dtype), (name, err)
        err = float((a.double() - w).abs().max())
        limit = kd.f64_tol(float((o.double() - w).abs().max()),
                           float(w.abs().max()))
        assert err <= limit, (name, err, limit)


def _bwd_args(args, chunk, seed, device):
    """``args`` padded to a multiple of ``min(chunk, S)`` as
    ``ops.ssd_scan`` pads them, random upstream gradients (``gy`` in x's
    type, ``gstate`` float32), and the chunk."""
    x = args[0]
    b, S, H, P = x.shape
    N = args[3].shape[-1]
    ch = min(chunk, S)
    pad = (-S) % ch
    F = torch.nn.functional
    x, dt, A, B, C, D = args
    padded = [F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
              F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)), D]
    gen = torch.Generator(device=device).manual_seed(seed)
    gy = torch.randn(padded[0].shape, generator=gen, device=device).to(x.dtype)
    gs = torch.randn((b, H, P, N), generator=gen, device=device)
    return padded, gy, gs, ch


def _check_bwd_against_plain(padded, gy, gs, ch):
    """The backward kernel (one counted launch) against
    ``ssd_scan_bwd_plain`` on the same inputs: each gradient in its
    prepared type, finite, within ``plain_tol`` at that type."""
    before = kd.SSD_SCAN_BWD.launches
    got = kd.ssd_scan_bwd_kernel(*padded, gy, gs, chunk=ch)
    torch.cuda.synchronize()
    assert kd.SSD_SCAN_BWD.launches == before + 1
    prepared = kd.prepare(*padded, ch)
    want = kd.ssd_scan_bwd_plain(*prepared, gy, gs, chunk=ch)
    for name, g, w, t in zip(NAMES, got, want, prepared):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
        err = float((g.float() - w.float()).abs().max())
        assert err <= kd.plain_tol(w.float(), g.dtype), (name, err)
    return got


# (b, S, H, P, N), chunk: the model's head and state with a ragged S; a
# chunk of 100 rows (not a multiple of the 64-row tile); Hymba's state of
# 16 at its head; P and N odd; a narrow head; one chunk of 16.  The bf16
# instance stages through TMA where P and N are multiples of 8, and copies
# x, gy, B and C into padded rows first where they are not (P 13 / N 20,
# P 12, N 20); N 200 takes two 128-column passes of the dC, dB and states
# kernels.
BWD_SHAPES = [((2, 300, 5, 64, 128), 256), ((1, 100, 3, 64, 128), 256),
              ((2, 512, 4, 64, 16), 256), ((1, 130, 2, 13, 20), 64),
              ((3, 100, 4, 8, 16), 64), ((3, 16, 5, 64, 128), 256),
              ((2, 256, 3, 12, 32), 64), ((2, 256, 3, 64, 20), 128),
              ((1, 512, 2, 64, 200), 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,chunk", BWD_SHAPES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_bwd_kernel_matches_plain(cuda, shape, chunk, dtype):
    args = _inputs(*shape, dtype, sum(shape), cuda)
    _check_bwd_against_plain(*_bwd_args(args, chunk, 3, cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["keys", "state", "slow"])
def test_bwd_kernel_on_cancelling_and_slowly_decaying_inputs(cuda, case,
                                                             dtype):
    """``tests/test_torch_cuda_ssd.py``'s inputs whose sums cancel to
    2^-10 of their terms (model head and state, chunk 256) and whose state
    survives a chunk, with random upstream gradients: the kernel within
    ``plain_tol`` of its plain version."""
    if case == "slow":
        raw = _slow_inputs(2, 1024, 5, torch.float32, seed=7)
    else:
        raw = cancelling_inputs(case, 1, 512, 2, 64, 128)
    x, dt, A, B, C, D = raw
    args = [t.to(cuda) for t in (x.to(dtype), dt, A, B.to(dtype), C.to(dtype),
                                 D)]
    _check_bwd_against_plain(*_bwd_args(args, 256, 5, cuda))


# the model's head and state (TMA), Hymba's state of 16 (TMA), a chunk of
# 100 rows, P 13 and N 20 (the padded copies)
BITS_SHAPES = [((2, 1024, 8, 64, 128), 256), ((2, 512, 4, 64, 16), 256),
               ((1, 200, 3, 64, 128), 100), ((1, 130, 2, 13, 20), 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,chunk", BITS_SHAPES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_bwd_kernel_gives_equal_bits_twice(cuda, shape, chunk, dtype):
    """No float atomics: two launches on the same inputs give the same
    bits, and a bare launch into buffers made beforehand (as
    ``chip_smoke.py`` times it) gives the wrapper's, on both staging
    routes."""
    args = _inputs(*shape, dtype, 9, cuda)
    padded, gy, gs, ch = _bwd_args(args, chunk, 11, cuda)
    first = kd.ssd_scan_bwd_kernel(*padded, gy, gs, chunk=ch)
    second = kd.ssd_scan_bwd_kernel(*padded, gy, gs, chunk=ch)
    prepared = kd.prepare(*padded, ch)
    bare = [torch.empty_like(t) for t in prepared]
    kd.launch_bwd(*prepared, gy, gs, *bare, ch,
                  stream=torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    for name, a, b, c in zip(NAMES, first, second, bare):
        assert torch.equal(a, b) and torch.equal(a, c), name


def _step_on(cfg, device, steps=2):
    params = init_params(cfg, 0, device="cpu")
    params = tree_map(lambda t: t.to(device), params)
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
    losses, launches = [], []
    for i in range(steps):
        batch = {"tokens": torch.from_numpy(batch_at(data, i)["tokens"]).to(
            device)}
        build.reset_launch_counts()
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
        launches.append((kd.SSD_SCAN.launches, kd.SSD_SCAN_BWD.launches))
    return losses, params, state, launches


@pytest.mark.parametrize("arch", ["mamba2_780m", "hymba_1_5b"])
def test_reduced_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Two f32 steps of the reduced config (remat full) from the same
    params: the card's losses within 1e-5 relative of the CPU's, the
    params and moments after them within 1e-5 of each leaf's max; D
    launches twice a layer a step on the card (the forward and the remat
    recompute) and its backward once, neither on the CPU."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              remat="full")
    got = _step_on(cfg, cuda)
    want = _step_on(cfg, torch.device("cpu"))
    for a, b in zip(got[0], want[0]):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert got[3] == [(2 * cfg.n_layers, cfg.n_layers)] * 2
    assert want[3] == [(0, 0)] * 2
    for tree_g, tree_w in ((got[1], want[1]), (got[2].mu, want[2].mu)):
        for a, b in zip(leaves(tree_g), leaves(tree_w)):
            err = float((a.cpu() - b).abs().max())
            assert err <= 1e-5 * max(float(b.abs().max()), 1e-30)


def test_launches_inside_a_train_step_with_microbatches(cuda):
    """The bf16 reduced Mamba-2 at 2 microbatches: 2 layers x 2 (remat) x
    2 microbatches = 8 launches of D a step; with remat none, 4; its
    backward 2 layers x 2 microbatches = 4 either way."""
    for remat, want in (("full", 8), ("none", 4)):
        cfg = dataclasses.replace(get_config("mamba2_780m").reduced(),
                                  remat=remat)
        params = init_params(cfg, 0, device=cuda)
        step, opt = make_train_step(cfg, microbatches=2)
        toks = torch.from_numpy(batch_at(
            DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4), 0)[
                "tokens"]).to(cuda)
        build.reset_launch_counts()
        _, _, loss = step(params, opt.init(params), {"tokens": toks})
        assert kd.SSD_SCAN.launches == want, remat
        assert kd.SSD_SCAN_BWD.launches == 4, remat
        assert np.isfinite(float(loss))
