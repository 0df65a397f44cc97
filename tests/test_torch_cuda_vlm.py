"""The VLM and encoder-decoder families on the card: the reduced
Llama-3.2-11B-Vision (1 and 2 groups, the cross gates set non-zero) and
Whisper-large-v3 at float32 on the card against the same models on the CPU
(the prefill logits at S = 32, 20 decode steps after
``prefill_cross_caches`` and the caches after them, within 1e-4
max(1, max|logit|)), with no kernel launched (no hand-written kernel lies
on these paths); and a decode step past the cache's end refused on the
card as on the CPU.

Every test here needs an NVIDIA card and skips elsewhere.  Run on the card
with ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_vlm.py``.
This file imports no JAX.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.models.serving import init_caches  # noqa: E402
from repro_torch.models.serving import prefill_cross_caches  # noqa: E402

pytestmark = pytest.mark.cuda

CASES = {"llama-1group": ("llama32_vision_11b", {}),
         "llama-2groups": ("llama32_vision_11b", {"n_layers": 4}),
         "whisper": ("whisper_large_v3", {})}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bound(want):
    return 1e-4 * max(1.0, float(want.abs().max()))


def _model(arch, change):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **change)
    params = init_params(cfg, 0, device="cpu")
    if "gate" in params.get("cross", {}):
        params["cross"]["gate"].fill_(0.75)  # tanh(0) would hide the path
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
    src = cfg.vis_seq if cfg.family == "vlm" else cfg.enc_seq
    stub = torch.randn(2, src, cfg.d_model, generator=gen,
                       dtype=torch.bfloat16)
    key = "vision" if cfg.family == "vlm" else "frames"
    return cfg, params, tokens, key, stub


@pytest.mark.parametrize("case", list(CASES))
def test_reduced_model_on_cuda_matches_cpu(cuda, case):
    cfg, params, tokens, key, stub = _model(*CASES[case])
    gparams = tree_map(lambda t: t.to(cuda), params)
    build.reset_launch_counts()
    got = make_prefill_step(cfg)(gparams, {"tokens": tokens.to(cuda),
                                           key: stub.to(cuda)})
    torch.cuda.synchronize()
    assert all(k.launches == 0 for k in build.KERNELS)
    want = make_prefill_step(cfg)(params, {"tokens": tokens, key: stub})
    assert float((got.cpu() - want).abs().max()) <= _bound(want)
    step = make_decode_step(cfg)
    caches = prefill_cross_caches(cfg, params,
                                  init_caches(cfg, 2, 20, device="cpu"),
                                  **{key: stub})
    gcaches = prefill_cross_caches(cfg, gparams,
                                   init_caches(cfg, 2, 20, device=cuda),
                                   **{key: stub.to(cuda)})
    for t in range(20):
        lg, caches = step(params, tokens[:, t:t + 1], caches, t)
        glg, gcaches = step(gparams, tokens[:, t:t + 1].to(cuda), gcaches, t)
        err = float((glg.cpu() - lg).abs().max())
        assert err <= _bound(lg), (t, err)
    flat = {(a, b): caches[a][b] for a in caches for b in caches[a]}
    for (a, b), c in flat.items():
        assert float((gcaches[a][b].cpu() - c).abs().max()) <= 1e-5 * max(
            1.0, float(c.abs().max())), (a, b)


def test_decode_past_the_cache_raises_on_cuda(cuda):
    cfg, params, tokens, key, stub = _model(*CASES["whisper"])
    gparams = tree_map(lambda t: t.to(cuda), params)
    caches = prefill_cross_caches(cfg, gparams,
                                  init_caches(cfg, 2, 4, device=cuda),
                                  **{key: stub.to(cuda)})
    step = make_decode_step(cfg)
    for t in range(4):
        step(gparams, tokens[:, t:t + 1].to(cuda), caches, t)
    before = caches["self"]["k"].clone()
    with pytest.raises(ValueError, match="past the cache"):
        step(gparams, tokens[:, 4:5].to(cuda), caches, 4)
    assert torch.equal(caches["self"]["k"], before)
