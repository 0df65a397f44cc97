"""The SSD chunk-scan kernel (kernel D) and the Mamba-2 path on the card:
the kernel against its plain PyTorch version at float32 and bfloat16, for
the model's chunk of 256 and the reference kernel's default of 64, with
ragged sequence lengths, head counts that are not a multiple of 8 and the
model's ``(P, N) = (64, 128)``, launch counts checked; at float32 against
the token-by-token recurrence ``ssd_ref`` and the model's ``ssd_chunked``;
with a slowly decaying state, whose carry from chunk to chunk shows in
the result; and the reduced Mamba-2 model on CUDA against the same model
on the CPU.

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
# ragged S; a narrow head; one chunk shorter than a 64-row slab
SHAPES = [(2, 300, 5, 64, 128), (1, 512, 3, 64, 128), (3, 100, 4, 8, 16),
          (2, 40, 7, 64, 128)]


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
