"""The training path on the card: kernel D's autograd Function (the CUDA
forward, the plain backward) against plain autograd through
``ssd_scan_plain``, at float32 and bfloat16; a reduced-config train step
on the card against the same step on the CPU; D's launch count inside a
train step (a layer's forward and its remat recompute, per microbatch).

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_function_grads_equal_plain_autograd(cuda, dtype):
    """One counted launch; ``y`` carries autograd history and lies within
    ``plain_tol`` of the plain version; every input's gradient is present
    and equals plain autograd's bit for bit (the backward recomputes the
    same plain operations)."""
    args = _inputs(2, 512, 6, 64, 32, dtype, 0, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    gy = torch.randn(args[0].shape, generator=gen, device=cuda).to(dtype)
    gs = torch.randn((2, 6, 64, 32), generator=gen, device=cuda)
    fn_in = [t.clone().requires_grad_() for t in args]
    build.reset_launch_counts()
    y, state = ops.ssd_scan(*fn_in, chunk=256)
    assert kd.SSD_SCAN.launches == 1
    assert y.grad_fn is not None
    got = torch.autograd.grad((y, state), fn_in, (gy, gs))
    assert kd.SSD_SCAN.launches == 1  # the backward launches nothing
    pl_in = [t.clone().requires_grad_() for t in args]
    py, ps = kd.ssd_scan_plain(*pl_in, chunk=256)
    want = torch.autograd.grad((py, ps), pl_in, (gy, gs))
    with torch.no_grad():
        assert float((y.float() - py.float()).abs().max()) <= kd.plain_tol(
            py.float(), dtype)
        assert float((state - ps).abs().max()) <= kd.plain_tol(
            ps, torch.float32)
    for name, a, b in zip(("x", "dt", "A", "B", "C", "D"), got, want):
        assert a is not None, f"no gradient for {name}"
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, b), name


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
        launches.append(kd.SSD_SCAN.launches)
    return losses, params, state, launches


@pytest.mark.parametrize("arch", ["mamba2_780m", "hymba_1_5b"])
def test_reduced_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Two f32 steps of the reduced config (remat full) from the same
    params: the card's losses within 1e-5 relative of the CPU's, the
    params and moments after them within 1e-5 of each leaf's max; D
    launches twice a layer a step on the card (the forward and the remat
    recompute) and never on the CPU."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              remat="full")
    got = _step_on(cfg, cuda)
    want = _step_on(cfg, torch.device("cpu"))
    for a, b in zip(got[0], want[0]):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert got[3] == [2 * cfg.n_layers] * 2 and want[3] == [0, 0]
    for tree_g, tree_w in ((got[1], want[1]), (got[2].mu, want[2].mu)):
        for a, b in zip(leaves(tree_g), leaves(tree_w)):
            err = float((a.cpu() - b).abs().max())
            assert err <= 1e-5 * max(float(b.abs().max()), 1e-30)


def test_launches_inside_a_train_step_with_microbatches(cuda):
    """The bf16 reduced Mamba-2 at 2 microbatches: 2 layers x 2 (remat) x
    2 microbatches = 8 launches a step; with remat none, 4."""
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
        assert np.isfinite(float(loss))
