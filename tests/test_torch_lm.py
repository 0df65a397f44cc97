"""The port's Mamba-2-780m inference path on CPU tensors against the
reference's, at its reduced config in float32
(``dataclasses.replace(cfg.reduced(), dtype="float32")``): the reference's
params carried across by ``lm_params_from_numpy`` (exactly equal), the
``make_prefill_step`` logits (the port's SSD through ``ssd_scan_plain``, the
reference's through ``ssd_chunked``) within 5e-4 max(1, max|logit|), each
of 10 ``decode_step``s within atol 2e-4 (``tests/test_models_smoke.py``'s),
and the port's own decode against its own forward.  Also the configs,
specs, init and ``serve``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.launch.steps import make_prefill_step as j_prefill  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models import serving as jS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as kd  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models import serving as S  # noqa: E402

ARCH = "mamba2_780m"
T = 10  # tokens: with the reduced chunk of 8 the prefill pads to 16


@pytest.fixture(scope="module")
def pair():
    """The reduced f32 config in both packages, the reference's params, the
    same params in the port, and (2, T) tokens."""
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    params = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, T))
    return jcfg, cfg, jparams, params, tokens


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_config_matches_the_reference():
    for full in (True, False):
        j = j_get_config(ARCH)
        t = get_config(ARCH)
        if not full:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert ARCH_IDS == ("arctic_480b", "qwen2_moe_a2_7b", "minicpm3_4b",
                        "deepseek_7b", "glm4_9b", "phi4_mini_3_8b",
                        "llama32_vision_11b", "hymba_1_5b", ARCH,
                        "whisper_large_v3")
    assert ARCH_IDS == J_ARCH_IDS  # all ten of the reference's, in its order
    assert get_config("mamba2-780m") is get_config(ARCH)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt2_small")  # no such architecture in either package
    assert SHAPES["prefill_32k"].seq_len == 32_768


def test_param_count_and_specs_match_the_reference():
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    assert cfg.param_count() == jcfg.param_count()
    specs = _flat(M.build_param_specs(cfg))
    jspecs = _flat(jM.build_param_specs(jcfg))
    assert set(specs) == set(jspecs)
    for k, s in specs.items():
        assert (s.shape, s.axes, s.scale) == (jspecs[k].shape, jspecs[k].axes,
                                             jspecs[k].scale), k


# the changes the port once refused, each on the reduced dense DeepSeek-7B
# (Mamba-2's SSM layers take none of them in the reference either); the
# reference's encoder reads a LayerNorm bias and a GELU MLP, so the
# encoder-decoder change brings both
FORMERLY_REFUSED = {
    "vlm": dict(family="vlm", cross_every=2, vis_seq=16),
    "encdec": dict(kind="encdec", enc_layers=2, enc_seq=16,
                   norm="layernorm", act="gelu"),
    "layernorm": dict(norm="layernorm"),
    "tied": dict(tie_embeddings=True),
    "gelu": dict(act="gelu"),
}


@pytest.mark.parametrize("change", list(FORMERLY_REFUSED.values()),
                         ids=list(FORMERLY_REFUSED))
def test_unported_configs_are_refused(change):
    """Named for when the port refused these configs: each is ported now,
    so the reduced config with the change builds the reference's specs
    field by field and matches its ``forward`` logits within 5e-4
    max(1, max|logit|) at f32 (a VLM's gates set non-zero and a vision
    stub fed, an encoder-decoder's frame stub fed)."""
    base = "deepseek_7b"
    jcfg = dataclasses.replace(j_get_config(base).reduced(), dtype="float32",
                               **change)
    cfg = dataclasses.replace(get_config(base).reduced(), dtype="float32",
                              **change)
    specs = _flat(M.build_param_specs(cfg))
    jspecs = _flat(jM.build_param_specs(jcfg))
    assert set(specs) == set(jspecs)
    for k, s in specs.items():
        assert (s.shape, s.axes, s.scale) == (jspecs[k].shape, jspecs[k].axes,
                                             jspecs[k].scale), k
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(5))
    if "gate" in jparams.get("cross", {}):
        jparams["cross"]["gate"] = jnp.full_like(jparams["cross"]["gate"], 0.8)
    params = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab, (2, 24))
    stub = rng.normal(0, 1, (2, 16, cfg.d_model)).astype(np.float32)
    kw = {}
    if cfg.family == "vlm":
        kw["vision"] = stub
    if cfg.kind == "encdec":
        kw["frames"] = stub
    want = np.asarray(jM.forward(jcfg, jparams, jnp.asarray(tokens), **{
        k: jnp.asarray(v) for k, v in kw.items()})[0])
    got, _ = M.forward(cfg, params, torch.tensor(tokens), **{
        k: torch.tensor(v) for k, v in kw.items()})
    bound = 5e-4 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= bound


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_carry_across_exactly(dtype):
    jcfg = dataclasses.replace(j_get_config(ARCH).reduced(), dtype=dtype)
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(3))
    params = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    got, want = _flat(params), _flat(jax.tree.map(np.asarray, jparams))
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.dtype == getattr(torch, dtype), k
        w = want[k]
        if dtype == "bfloat16":
            t, w = t.view(torch.int16), w.view(np.int16)  # bit patterns
        np.testing.assert_array_equal(t.numpy(), w, err_msg=k)


def test_init_params_follow_their_specs():
    cfg = get_config(ARCH).reduced()
    params = M.init_params(cfg, 7, device="cpu")
    flat = _flat(params)
    specs = _flat(M.build_param_specs(cfg))
    assert set(flat) == set(specs)
    for k, t in flat.items():
        s = specs[k]
        assert tuple(t.shape) == s.shape and t.dtype == torch.bfloat16, k
        if s.scale == "zero":
            assert not t.any(), k
        elif s.scale == "one":
            assert bool((t == 1).all()), k
        else:
            std = (min(1.0, max(s.shape[0] if len(s.shape) == 1 else
                                int(np.prod(s.shape[:-1])), 1) ** -0.5)
                   if s.scale == "fan_in" else s.scale)
            assert float(t.float().abs().max()) <= 2 * std * 1.01, k
    again = M.init_params(cfg, 7, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(prm.leaves(params), prm.leaves(again)))


def test_prefill_logits_match_the_reference(pair):
    jcfg, cfg, jparams, params, tokens = pair
    want = np.asarray(j_prefill(jcfg)(jparams, {"tokens": jnp.asarray(tokens)}))
    got = make_prefill_step(cfg)(params, {"tokens": torch.tensor(tokens)})
    assert tuple(got.shape) == (2, cfg.vocab)
    bound = 5e-4 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= bound


def test_forward_logits_match_the_reference(pair):
    jcfg, cfg, jparams, params, tokens = pair
    want, _, _ = jM.forward(jcfg, jparams, jnp.asarray(tokens))
    got, caches = M.forward(cfg, params, torch.tensor(tokens))
    assert caches is None
    want = np.asarray(want)
    bound = 5e-4 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= bound


def test_decode_steps_match_the_reference(pair):
    jcfg, cfg, jparams, params, tokens = pair
    jcaches = jS.init_caches(jcfg, 2, T)
    caches = S.init_caches(cfg, 2, T, device="cpu")
    step = make_decode_step(cfg)
    for t in range(T):
        want, jcaches = jS.decode_step(jcfg, jparams,
                                       jnp.asarray(tokens[:, t:t + 1]),
                                       jcaches, jnp.int32(t))
        got, caches = step(params, torch.tensor(tokens[:, t:t + 1]), caches, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                                   err_msg=f"step {t}")
    for k in ("conv", "state"):
        np.testing.assert_allclose(caches[k].numpy(), np.asarray(jcaches[k]),
                                   atol=2e-4, err_msg=k)


def test_decode_matches_forward(pair):
    """The port alone: token-by-token decode reproduces its forward."""
    _, cfg, _, params, tokens = pair
    full, _ = M.forward(cfg, params, torch.tensor(tokens))
    caches = S.init_caches(cfg, 2, T, device="cpu")
    for t in range(T):
        lg, caches = S.decode_step(cfg, params, torch.tensor(tokens[:, t:t + 1]),
                                   caches, t)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=2e-4,
                                   err_msg=f"step {t}")


def test_decode_updates_the_caches_in_place(pair):
    _, cfg, _, params, tokens = pair
    caches = S.init_caches(cfg, 2, T, device="cpu")
    state = caches["state"]
    _, out = S.decode_step(cfg, params, torch.tensor(tokens[:, :1]), caches, 0)
    assert out is caches and out["state"] is state and bool(state.any())


def test_caches_follow_the_reference():
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
        jcfg = dataclasses.replace(j_get_config(ARCH).reduced(), dtype=dtype)
        got = S.init_caches(cfg, 3, 16, device="cpu")
        want = jS.init_caches(jcfg, 3, 16)
        assert set(got) == set(want) == {"conv", "state"}
        for k in got:
            assert tuple(got[k].shape) == want[k].shape
            assert got[k].dtype == getattr(torch, dtype)  # the config's dtype
            assert not got[k].any()


def test_prefill_runs_the_ssd_once_per_layer(pair, monkeypatch):
    from repro_torch.models import ssm

    _, cfg, _, params, tokens = pair
    calls = []
    real = ssm.ssd_scan

    def counting(*a, chunk):
        calls.append(chunk)
        return real(*a, chunk=chunk)

    monkeypatch.setattr(ssm, "ssd_scan", counting)
    before = kd.SSD_SCAN.launches
    make_prefill_step(cfg)(params, {"tokens": torch.tensor(tokens)})
    assert calls == [cfg.ssd_chunk] * cfg.n_layers
    assert kd.SSD_SCAN.launches == before  # CPU: the plain version


def test_bf16_forward_is_finite():
    cfg = get_config(ARCH).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 21),
                           generator=torch.Generator().manual_seed(0))
    logits, _ = M.forward(cfg, params, tokens)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())


def test_serve_returns_valid_tokens():
    gen, tps = serve(ARCH, batch=3, prompt_len=5, new_tokens=6, reduced=True,
                     device="cpu")
    cfg = get_config(ARCH).reduced()
    assert tuple(gen.shape) == (3, 6) and tps > 0
    assert int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab
    again, _ = serve(ARCH, batch=3, prompt_len=5, new_tokens=6, reduced=True,
                     device="cpu")
    assert torch.equal(gen, again)  # seeded


def test_serve_main_prints(capsys):
    serve_main(["--arch", ARCH, "--batch", "2", "--tokens", "3",
                "--device", "cpu"])
    assert "generated (2, 3) tokens" in capsys.readouterr().out
