"""The SSD chunk-scan kernel (kernel D) and the Mamba-2 path on the card:
the kernel against its plain PyTorch version at float32 and bfloat16, for
the model's chunk of 256 and the reference kernel's default of 64, with
ragged sequence lengths, head counts that are not a multiple of 8, the
model's ``(P, N) = (64, 128)`` and widths the tensor-core tiling must pad
(N = 20 and 40, P = 13 and 24, Q = 16), launch counts checked; at float32
against the token-by-token recurrence ``ssd_ref`` and the model's
``ssd_chunked``; with a slowly decaying state, whose carry from chunk to
chunk shows in the result, with one head's x 10^3 larger than the rest's,
and with sums that cancel to 2^-10 of their terms, where fewer bf16 parts
of a float32 operand would show; the bare launch against the wrapper bit
for bit; two bf16 blocks a SM at the model's shape; and the reduced
Mamba-2 model on CUDA against the same model on the CPU.

Every test here needs an NVIDIA card with nvcc and skips elsewhere.  Run on
the card with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda_ssd.py``.  This file imports no JAX.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as kd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.models.serving import init_caches  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, S, H, P, N, dtype, seed):
    """The reference kernel tests' recipe: dt = softplus(normal), A =
    -exp(normal(0, 0.5)), the rest standard normal."""
    rng = np.random.default_rng(seed)
    f32 = torch.float32
    x = torch.tensor(rng.normal(0, 1, (b, S, H, P)), dtype=f32)
    dt = torch.nn.functional.softplus(
        torch.tensor(rng.normal(0, 1, (b, S, H)), dtype=f32))
    A = -torch.exp(torch.tensor(rng.normal(0, 0.5, (H,)), dtype=f32))
    B = torch.tensor(rng.normal(0, 1, (b, S, N)), dtype=f32)
    C = torch.tensor(rng.normal(0, 1, (b, S, N)), dtype=f32)
    D = torch.tensor(rng.normal(0, 1, (H,)), dtype=f32)
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype), D


def test_ssd_library_builds(cuda):
    print(build.build(["ssd_scan"])["ssd_scan"])
    assert build.library_path("ssd_scan").is_file()


# (b, S, H, P, N): the model's head (64, 128) with 5 and 3 heads and a
# ragged S; a narrow head; one chunk shorter than a 64-row slab; N a
# multiple of 8 but not of 16; P = 24 (padded to the tile's 64); P odd and
# N not a multiple of 8 (tiles staged with plain loads); Q = 16
SHAPES = [(2, 300, 5, 64, 128), (1, 512, 3, 64, 128), (3, 100, 4, 8, 16),
          (2, 40, 7, 64, 128), (2, 200, 3, 64, 40), (2, 96, 3, 24, 16),
          (1, 130, 2, 13, 20), (3, 16, 5, 64, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, shape, chunk, dtype):
    tdt = getattr(torch, dtype)
    args = [t.to(cuda) for t in _inputs(*shape, tdt, seed=sum(shape))]
    S = shape[1]
    before = kd.SSD_SCAN.launches
    y, state = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert kd.SSD_SCAN.launches == before + 1
    # the plain version on the same padded inputs ops.ssd_scan made
    ch = min(chunk, S)
    pad = (-S) % ch
    x, dt, A, B, C, D = args
    F = torch.nn.functional
    py, pstate = kd.ssd_scan_plain(
        F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
        F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)), D, chunk=ch)
    py = py[:, :S]
    assert y.dtype == tdt and tuple(y.shape) == tuple(x.shape)
    assert state.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())
    err = float((y.float() - py.float()).abs().max())
    assert err <= kd.plain_tol(py.float(), tdt), err
    serr = float((state - pstate).abs().max())
    assert serr <= kd.plain_tol(pstate, torch.float32), serr


@pytest.mark.parametrize("chunk", [64, 256])
def test_kernel_matches_the_recurrence_and_chunked(cuda, chunk):
    """At float32, the kernel against the port's two other SSD
    formulations: the token-by-token recurrence and the model's chunked
    scan (which materialises the whole masked decay), each a different
    order of the same float32 sums."""
    args = [t.to(cuda) for t in _inputs(2, 512, 3, 64, 128, torch.float32,
                                        seed=chunk)]
    y, state = kd.ssd_scan_kernel(*args, chunk=chunk)
    for name, (ry, rstate) in (("ssd_ref", ssd_ref(*args)),
                               ("ssd_chunked",
                                ssm.ssd_chunked(*args, chunk=chunk))):
        err = float((y - ry).abs().max())
        assert err <= kd.plain_tol(ry, torch.float32), (name, err)
        serr = float((state - rstate).abs().max())
        assert serr <= kd.plain_tol(rstate, torch.float32), (name, serr)


def _slow_inputs(b, S, H, dtype, seed):
    """Inputs whose state survives a chunk of 256: dt log-uniform in
    [1e-3, 0.1] (Mamba-2's dt initialisation range) and ``A = -10^u`` for
    u evenly from -2 to 0 across the heads, so that ``exp(sum dt A)`` over
    a chunk runs from about 0.95 down to about 0.005; x, B, C and D as in
    :func:`_inputs` at ``(P, N) = (64, 128)``."""
    x, _, _, B, C, D = _inputs(b, S, H, 64, 128, dtype, seed)
    rng = np.random.default_rng(seed + 1)
    dt = torch.tensor(np.exp(rng.uniform(np.log(1e-3), np.log(0.1),
                                         (b, S, H))), dtype=torch.float32)
    A = -torch.logspace(-2, 0, H)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_carries_a_slowly_decaying_state(cuda, dtype):
    """With the model's chunk of 256 and its head, where the state from
    one chunk still weighs in the next: the kernel's y and final state
    against the plain version, and its final state against a run one
    chunk shorter advanced over the last chunk by hand,
    ``h = exp(sum_last dt A) h_short + (the last chunk's own state)``."""
    Q, b, S, H = 256, 2, 1024, 5
    tdt = getattr(torch, dtype)
    args = [t.to(cuda) for t in _slow_inputs(b, S, H, tdt, seed=7)]
    x, dt, A, B, C, D = args
    per_chunk = torch.exp((dt * A).reshape(b, S // Q, Q, H).sum(2))
    # the data must carry: most heads keep over 5 % of the state a chunk
    assert float(per_chunk.median()) > 0.05, float(per_chunk.median())
    before = kd.SSD_SCAN.launches
    y, state = kd.ssd_scan_kernel(*args, chunk=Q)
    assert kd.SSD_SCAN.launches == before + 1
    py, pstate = kd.ssd_scan_plain(*args, chunk=Q)
    err = float((y.float() - py.float()).abs().max())
    assert err <= kd.plain_tol(py.float(), tdt), err
    serr = float((state - pstate).abs().max())
    assert serr <= kd.plain_tol(pstate, torch.float32), serr
    head = [t[:, :S - Q] if t.dim() > 1 else t for t in args]
    last = [t[:, S - Q:] if t.dim() > 1 else t for t in args]
    _, h_short = kd.ssd_scan_kernel(*head, chunk=Q)
    _, h_last = kd.ssd_scan_plain(*last, chunk=Q)
    want = h_short * per_chunk[:, -1, :, None, None] + h_last
    herr = float((state - want).abs().max())
    assert herr <= kd.plain_tol(want, torch.float32), herr


def cancelling_inputs(case, b, S, H, P, N):
    """float32 inputs, exact in bf16, whose y (``"keys"``) or carried
    state's term in y (``"state"``) is a sum of terms up to 2^10 times its
    size, built so that rounding a float32 operand of the kernel's
    products to fewer bf16 parts errs the same way in every term.

    ``"keys"``: every score ``C[q] . B[k]`` is 1; x is +1 and -1 on
    alternate tokens and dt is 2^-4 (1 + 3 2^-10) and 2^-4 (1 + 5 2^-10),
    so a pair of keys cancels in y and in the state while bf16(dt) rounds
    down on one and up on the other.  A is -1e-6 on even heads (G's
    rounding the same along a row) and -1e-2 on odd heads (the state's
    terms decay apart).  ``"state"``: the first two tokens (x = 1) write
    the state ``2^-4 (1 + B[1, n])`` with ``B[1, n]`` = 3 2^-10 at even n
    and 5 2^-10 at odd n, which ``C`` = +1, -1 at even, odd n cancels
    pairwise in every later y; N must be even.  D is 0 in both."""
    f32 = torch.float32
    x = torch.zeros((b, S, H, P), dtype=f32)
    dt = torch.full((b, S, H), 2.0 ** -4)
    A = torch.where(torch.arange(H) % 2 == 0, -1e-6, -1e-2).to(f32)
    B = torch.zeros((b, S, N), dtype=f32)
    C = torch.zeros((b, S, N), dtype=f32)
    odd_n = torch.arange(N) % 2 == 1
    if case == "keys":
        odd = (torch.arange(S) % 2 == 1)[None, :, None]
        dt = dt * (1 + torch.where(odd, 5.0, 3.0) * 2.0 ** -10)
        x[:] = torch.where(odd, -1.0, 1.0)[..., None]
        B[..., 0] = 1
        C[..., 0] = 1
    else:
        x[:, :2] = 1
        B[:, 0] = 1
        B[:, 1] = torch.where(odd_n, 5.0, 3.0) * 2.0 ** -10
        C[:] = torch.where(odd_n, -1.0, 1.0)
    return x, dt.contiguous(), A, B, C, torch.zeros(H)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["keys", "state"])
@pytest.mark.parametrize("shape", [(256, 8, 16, 64), (512, 64, 128, 256)],
                         ids=["small", "model"])
def test_kernel_holds_cancelling_sums(cuda, shape, case, dtype):
    """On :func:`cancelling_inputs` y and the state within ``plain_tol``:
    a bf16 kernel that took one bf16 part of G (``"keys"``) or of the
    carried state (``"state"``), or two of x' = w x (``"keys"``, the
    small shape), fails here (``tests/test_torch_ssd_scan.py`` emulates
    each)."""
    S, P, N, Q = shape
    tdt = getattr(torch, dtype)
    x, dt, A, B, C, D = cancelling_inputs(case, 1, S, 2, P, N)
    args = [t.to(cuda) for t in (x.to(tdt), dt, A, B.to(tdt), C.to(tdt), D)]
    y, state = kd.ssd_scan_kernel(*args, chunk=Q)
    py, pstate = kd.ssd_scan_plain(*args, chunk=Q)
    err = float((y.float() - py.float()).abs().max())
    assert err <= kd.plain_tol(py.float(), tdt), err
    serr = float((state - pstate).abs().max())
    assert serr <= kd.plain_tol(pstate, torch.float32), serr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_holds_a_state_spanning_orders_of_magnitude(cuda, dtype):
    """The slow-decay inputs with x scaled by 10^3 on one head, so the
    state's entries span several orders of magnitude: y and the state
    within ``plain_tol`` of the plain version's, the state also head by
    head against each head's own magnitude."""
    Q, b, S, H = 256, 2, 768, 4
    x, dt, A, B, C, D = _slow_inputs(b, S, H, torch.float32, seed=13)
    x[:, :, 1] *= 1e3
    tdt = getattr(torch, dtype)
    args = [t.to(cuda) for t in (x.to(tdt), dt, A, B.to(tdt), C.to(tdt), D)]
    y, state = kd.ssd_scan_kernel(*args, chunk=Q)
    py, pstate = kd.ssd_scan_plain(*args, chunk=Q)
    mags = pstate.abs().amax(dim=(0, 2, 3))
    assert float(mags.max() / mags.min()) > 1e2, mags
    err = float((y.float() - py.float()).abs().max())
    assert err <= kd.plain_tol(py.float(), tdt), err
    serr = float((state - pstate).abs().max())
    assert serr <= kd.plain_tol(pstate, torch.float32), serr
    for i in range(H):
        herr = float((state[:, i] - pstate[:, i]).abs().max())
        assert herr <= kd.plain_tol(pstate[:, i], torch.float32), (i, herr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bare_launch_equals_the_wrapper(cuda, dtype):
    """``launch`` into buffers made beforehand (as ``chip_smoke.py`` times
    it) gives the wrapper's y and state bit for bit."""
    tdt = getattr(torch, dtype)
    raw = [t.to(cuda) for t in _inputs(2, 512, 3, 64, 128, tdt, seed=17)]
    want_y, want_state = kd.ssd_scan_kernel(*raw, chunk=256)
    args = kd.prepare(*raw, 256)
    y = torch.full_like(want_y, float("nan"))
    state = torch.full_like(want_state, float("nan"))
    kd.launch(*args, y, state, 256,
              stream=torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert torch.equal(y, want_y) and torch.equal(state, want_state)


def test_two_blocks_a_sm_at_the_model_shape(cuda):
    """The bf16 instance at the model's (P, N, Q) = (64, 128, 256) fits two
    blocks on an SM, with the shared memory a launch there passes."""
    assert kd.resident_blocks(64, 128, 256, torch.bfloat16, cuda) >= 2
    assert kd.resident_blocks(64, 128, 256, torch.float32, cuda) >= 1


def test_kernel_refuses_a_wide_head(cuda):
    args = [t.to(cuda) for t in _inputs(1, 64, 2, 65, 8, torch.float32, 0)]
    with pytest.raises(ValueError, match="P <= 64"):
        kd.ssd_scan_kernel(*args, chunk=64)


def _reduced(dtype):
    return dataclasses.replace(get_config("mamba2_780m").reduced(),
                               dtype=dtype)


def test_reduced_model_on_cuda_matches_cpu(cuda):
    cfg = _reduced("float32")
    params = init_params(cfg, 0, device="cpu")
    gparams = tree_map(lambda t: t.to(cuda), params)
    tokens = torch.randint(0, cfg.vocab, (2, 37),
                           generator=torch.Generator().manual_seed(1))
    build.reset_launch_counts()
    got = make_prefill_step(cfg)(gparams, {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    assert kd.SSD_SCAN.launches == cfg.n_layers
    want = make_prefill_step(cfg)(params, {"tokens": tokens})
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(want.abs().max())), err
    step = make_decode_step(cfg)
    caches = init_caches(cfg, 2, 4, device="cpu")
    gcaches = init_caches(cfg, 2, 4, device=cuda)
    for t in range(4):
        lg, caches = step(params, tokens[:, t:t + 1], caches, t)
        glg, gcaches = step(gparams, tokens[:, t:t + 1].to(cuda), gcaches, t)
        err = float((glg.cpu() - lg).abs().max())
        assert err <= 1e-4 * max(1.0, float(lg.abs().max())), (t, err)
