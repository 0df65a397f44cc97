"""The SSD chunk-scan kernel (kernel D) at Hymba-1.5B's Mamba heads and the
reduced hybrid and dense models on the card: the kernel at ``(H, P, N) =
(50, 64, 16)`` with chunk 256 against its plain PyTorch version at float32
and bfloat16, and at float32 against the token-by-token recurrence
``ssd_ref``, which reads ``B`` and ``C`` shared across the heads (one
group) as the Mamba-2 path does; the blocks an SM holds at ``(P, N, Q) =
(64, 16, 256)``; the reduced Hymba prefill on the card with one launch of
D a layer, and its prefill and decode, and a reduced dense model's,
against the same models on the CPU.

Every test here needs an NVIDIA card with nvcc and skips elsewhere.  Run on
the card with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda_hybrid.py``.  This file imports no JAX.
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
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.models.serving import init_caches  # noqa: E402

pytestmark = pytest.mark.cuda

HYMBA = get_config("hymba_1_5b")
HEADS = (HYMBA.ssm_heads, HYMBA.ssm_head_dim, HYMBA.ssm_state)  # 50, 64, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, S, H, P, N, dtype, seed, device):
    """dt = softplus(normal), A = -exp(normal(0, 0.5)), the rest standard
    normal (the reference kernel tests' recipe)."""
    rng = np.random.default_rng(seed)
    f32 = torch.float32
    x = torch.tensor(rng.normal(0, 1, (b, S, H, P)), dtype=f32)
    dt = torch.nn.functional.softplus(
        torch.tensor(rng.normal(0, 1, (b, S, H)), dtype=f32))
    A = -torch.exp(torch.tensor(rng.normal(0, 0.5, (H,)), dtype=f32))
    B = torch.tensor(rng.normal(0, 1, (b, S, N)), dtype=f32)
    C = torch.tensor(rng.normal(0, 1, (b, S, N)), dtype=f32)
    D = torch.tensor(rng.normal(0, 1, (H,)), dtype=f32)
    return [t.to(device) for t in
            (x.to(dtype), dt, A, B.to(dtype), C.to(dtype), D)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1024, 1088], ids=["S1024", "S1088-padded"])
def test_kernel_at_hymba_heads_matches_plain(cuda, S, dtype):
    tdt = getattr(torch, dtype)
    args = _inputs(2, S, *HEADS, tdt, seed=S, device=cuda)
    before = kd.SSD_SCAN.launches
    y, state = ops.ssd_scan(*args, chunk=HYMBA.ssd_chunk)
    torch.cuda.synchronize()
    assert kd.SSD_SCAN.launches == before + 1
    pad = (-S) % HYMBA.ssd_chunk
    F = torch.nn.functional
    x, dt, A, B, C, D = args
    py, pstate = kd.ssd_scan_plain(
        F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
        F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)), D,
        chunk=HYMBA.ssd_chunk)
    py = py[:, :S]
    assert y.dtype == tdt and tuple(state.shape) == (2, *HEADS)
    err = float((y.float() - py.float()).abs().max())
    assert err <= kd.plain_tol(py.float(), tdt), err
    serr = float((state - pstate).abs().max())
    assert serr <= kd.plain_tol(pstate, torch.float32), serr


def test_kernel_reads_b_and_c_shared_across_heads(cuda):
    """At float32 against the token-by-token recurrence, whose every head
    reads the one group's B[t] and C[t]."""
    args = _inputs(1, 512, *HEADS, torch.float32, seed=3, device=cuda)
    y, state = kd.ssd_scan_kernel(*args, chunk=256)
    ry, rstate = ssd_ref(*args)
    assert float((y - ry).abs().max()) <= kd.plain_tol(ry, torch.float32)
    assert float((state - rstate).abs().max()) <= kd.plain_tol(
        rstate, torch.float32)


def test_resident_blocks_at_hymba_heads(cuda):
    P, N, Q = HYMBA.ssm_head_dim, HYMBA.ssm_state, HYMBA.ssd_chunk
    assert kd.resident_blocks(P, N, Q, torch.bfloat16, cuda) >= 2
    assert kd.resident_blocks(P, N, Q, torch.float32, cuda) >= 1


@pytest.mark.parametrize("arch", ["hymba_1_5b", "phi4_mini_3_8b"])
def test_reduced_model_on_cuda_matches_cpu(cuda, arch):
    """The reduced f32 prefill (chunked attention; D once a layer for the
    hybrid) and 20 decode steps past the window, on the card against the
    CPU."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    gparams = tree_map(lambda t: t.to(cuda), params)
    tokens = torch.randint(0, cfg.vocab, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    build.reset_launch_counts()
    got = make_prefill_step(cfg)(gparams, {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    want_launches = cfg.n_layers if cfg.family == "hybrid" else 0
    assert kd.SSD_SCAN.launches == want_launches
    want = make_prefill_step(cfg)(params, {"tokens": tokens})
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(want.abs().max())), err
    step = make_decode_step(cfg)
    caches = init_caches(cfg, 2, 20, device="cpu")
    gcaches = init_caches(cfg, 2, 20, device=cuda)
    for t in range(20):
        lg, caches = step(params, tokens[:, t:t + 1], caches, t)
        glg, gcaches = step(gparams, tokens[:, t:t + 1].to(cuda), gcaches, t)
        err = float((glg.cpu() - lg).abs().max())
        assert err <= 1e-4 * max(1.0, float(lg.abs().max())), (t, err)
