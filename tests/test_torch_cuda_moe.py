"""The MoE and MLA families on the card: the reduced Qwen1.5-MoE-A2.7B,
Arctic-480B and MiniCPM3-4B at float32 on the card against the same
models on the CPU (the prefill logits at S = 32, 20 decode steps and the
caches after them, within 1e-4 max(1, max|logit|)), with no kernel
launched (these families' paths have no hand-written kernel); and the
port's dispatch against ``chip_smoke.py``'s token-by-token loop on the
card at a small size (the same dropped claims, outputs within 1e-5 of
max|loop|).

Every test here needs an NVIDIA card and skips elsewhere.  Run on the card
with ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_moe.py``.
This file imports no JAX.
"""

import dataclasses
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.models.serving import init_caches  # noqa: E402

pytestmark = pytest.mark.cuda

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bound(want):
    return 1e-4 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "arctic_480b",
                                  "minicpm3_4b"])
def test_reduced_model_on_cuda_matches_cpu(cuda, arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    gparams = tree_map(lambda t: t.to(cuda), params)
    tokens = torch.randint(0, cfg.vocab, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    build.reset_launch_counts()
    got = make_prefill_step(cfg)(gparams, {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    assert all(k.launches == 0 for k in build.KERNELS)
    want = make_prefill_step(cfg)(params, {"tokens": tokens})
    assert float((got.cpu() - want).abs().max()) <= _bound(want)
    step = make_decode_step(cfg)
    caches = init_caches(cfg, 2, 20, device="cpu")
    gcaches = init_caches(cfg, 2, 20, device=cuda)
    for t in range(20):
        lg, caches = step(params, tokens[:, t:t + 1], caches, t)
        glg, gcaches = step(gparams, tokens[:, t:t + 1].to(cuda), gcaches, t)
        err = float((glg.cpu() - lg).abs().max())
        assert err <= _bound(lg), (t, err)
    for k, c in caches.items():
        assert float((gcaches[k].cpu() - c).abs().max()) <= 1e-5 * max(
            1.0, float(c.abs().max())), k


def test_dispatch_matches_the_loop_on_cuda(cuda):
    """Qwen's 60 experts and top-4 at d_model 256, 4 groups of 256 tokens
    at capacity 17 (its capacity factor of 1): routed once, then the
    port's dispatch and expert einsums against the loop."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(get_config("qwen2_moe_a2_7b"), n_layers=1,
                              d_model=256, moe_d_ff=128, d_ff=128, vocab=64,
                              n_heads=2, n_kv_heads=2, dtype="float32")
    p = tree_map(lambda t: t[0],
                 init_params(cfg, 0, device=cuda)["layers"]["moe"])
    gen = torch.Generator(device=cuda).manual_seed(2)
    xg = torch.randn((4, 256, cfg.d_model), generator=gen, device=cuda)
    idx, w = moe.route_topk(torch.einsum("gtd,de->gte", xg, p["router"]),
                            cfg.top_k)
    capacity = 256 * cfg.top_k // cfg.n_experts
    disp, comb = moe.dispatch_combine(xg, idx, w, cfg.n_experts, capacity)
    y = torch.einsum("gtec,gecd->gtd", comb, moe.experts(p, disp))
    want, dropped = smoke.moe_loop_reference(xg, idx, w, p, capacity)
    assert smoke.dropped_claims(comb, idx) == dropped
    assert 0 < len(dropped) < idx.numel()
    err, mag = float((y - want).abs().max()), float(want.abs().max())
    assert mag > 0 and err <= 1e-5 * mag, (err, mag)
