"""The port's training path on CPU tensors against the reference's, at
reduced configs in float32.

* ``chunked_attention``'s backward against ``dense_attention``'s (causal,
  windowed, MLA's 96-wide keys with 64-wide values, a cross block): the
  online softmax edited its score blocks in place, and autograd refused
  the backward;
* kernel D's autograd Function (``ssd_scan``): the same ``y``, state and
  input gradients as plain autograd through ``ssd_scan_plain``, a gradient
  for every input, and the mixer's params' gradients against the mixer
  with the reference's ``ssd_chunked`` in the kernel's place;
* ``chunked_ce`` against the reference's, with a sequence the chunk does
  not divide; ``lm_loss`` and every gradient leaf against
  ``jax.value_and_grad(lm_loss)`` for one reduced config per family;
* ``remat`` ``none`` / ``full`` / ``dots``: the same loss and gradients,
  and the remat modes run each SSD forward twice; an inference forward
  (nothing requires grad) checkpoints nothing;
* ``make_train_step`` at 1 and 2 microbatches against the reference's over
  two steps (step 0's learning rate is 0), params and ``AdamWState``
  carried across; its bfloat16 ``grad_dtype`` and ``accum_dtype`` against
  the reference's same options; an uneven microbatch split refused.

Limits: losses within 1e-5 relative; every gradient leaf within 1e-4 of
its own max |grad| (f32 sums in another order through two layers and the
backward); attention gradients within 1e-5 of their max.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_at  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as kd  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_prefill_step,
    make_train_step,
)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.params import leaves, tree_map  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's own max |grad|
ATTN_TOL = 1e-5  # of the gradient's max


def _np(t):
    return t.detach().numpy()


def _assert_tree_close(got, want, tol, what=""):
    """Every leaf of ``got`` (a tree of tensors, or its leaves as a list)
    within ``tol`` of the max |.| of the matching leaf of ``want`` (numpy,
    jax.tree order = sorted keys)."""
    g = got if isinstance(got, list) else leaves(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b, dtype=np.float32)
        err = float(np.abs(_np(a).astype(np.float32) - b).max())
        assert err <= tol * float(np.abs(b).max()), (what, a.shape, err,
                                                     float(np.abs(b).max()))


# ---------------------------------------------------------------------------
# chunked attention's backward
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (Sq, Skv, H, Hkv, d_qk, d_v, causal, window, q_chunk, kv_chunk)
    "causal": (64, 64, 4, 2, 16, 16, True, 0, 16, 16),
    "windowed": (64, 64, 4, 2, 16, 16, True, 24, 16, 16),
    "mla": (48, 48, 4, 4, 96, 64, True, 0, 16, 16),
    "cross": (64, 48, 4, 2, 16, 16, False, 0, 16, 24),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_backward_matches_dense(case):
    """The gradients of q, k and v through the online softmax against the
    materialized softmax, under the same random upstream gradient."""
    sq, skv, h, hkv, dqk, dv, causal, window, qc, kc = ATTN_CASES[case]
    rng = np.random.default_rng(1)
    q, k = (torch.tensor(rng.normal(0, 1, (2, s, n, dqk)), dtype=torch.float32,
                         requires_grad=True)
            for s, n in ((sq, h), (skv, hkv)))
    v = torch.tensor(rng.normal(0, 1, (2, skv, hkv, dv)), dtype=torch.float32,
                     requires_grad=True)
    up = torch.tensor(rng.normal(0, 1, (2, sq, h, dv)), dtype=torch.float32)
    got = L.chunked_attention(q, k, v, causal=causal, window=window,
                              q_chunk=qc, kv_chunk=kc)
    g_got = torch.autograd.grad(got, (q, k, v), up)
    want = L.dense_attention(q, k, v, causal=causal, window=window)
    g_want = torch.autograd.grad(want, (q, k, v), up)
    got, want = got.detach(), want.detach()
    assert float((got - want).abs().max()) <= ATTN_TOL * float(
        want.abs().max())
    for name, a, b in zip("qkv", g_got, g_want):
        err = float((a - b).abs().max())
        assert err <= ATTN_TOL * float(b.abs().max()), (case, name, err)


@pytest.mark.parametrize("arch", [
    "hymba_1_5b", "deepseek_7b", "glm4_9b", "phi4_mini_3_8b", "minicpm3_4b",
    "qwen2_moe_a2_7b", "arctic_480b", "llama32_vision_11b",
    "whisper_large_v3"])
def test_every_attention_family_differentiates_chunked(arch):
    """``forward(..., chunked=True)`` at S = 2 x attn_chunk: the backward
    runs and every param the logits reach gets a finite gradient."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = tree_map(lambda t: t.requires_grad_(),
                      M.init_params(cfg, 0, device="cpu"))
    if "cross" in params and "gate" in params["cross"]:
        with torch.no_grad():
            params["cross"]["gate"].fill_(0.5)  # the cross path reaches x
    rng = np.random.default_rng(0)
    kw = {}
    if cfg.family == "vlm":
        kw["vision"] = torch.tensor(rng.normal(
            0, 1, (2, cfg.vis_seq, cfg.d_model)), dtype=torch.float32)
    if cfg.kind == "encdec":
        kw["frames"] = torch.tensor(rng.normal(
            0, 1, (2, cfg.enc_seq, cfg.d_model)), dtype=torch.float32)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (2, 2 * cfg.attn_chunk)))
    logits, _ = M.forward(cfg, params, tokens, chunked=True, **kw)
    flat = leaves(params)
    grads = torch.autograd.grad(logits.square().mean(), flat,
                                allow_unused=True)
    for p, g in zip(flat, grads):
        if g is not None:
            assert bool(torch.isfinite(g).all())
    assert sum(g is not None for g in grads) >= len(flat) - 1  # a tied head


# ---------------------------------------------------------------------------
# kernel D's autograd Function
# ---------------------------------------------------------------------------


def _ssd_inputs(b, S, H, P, N, seed):
    """The reference kernel tests' recipe, as leaves that want gradients."""
    rng = np.random.default_rng(seed)
    f32 = torch.float32
    x = torch.tensor(rng.normal(0, 1, (b, S, H, P)), dtype=f32)
    dt = torch.nn.functional.softplus(
        torch.tensor(rng.normal(0, 1, (b, S, H)), dtype=f32))
    A = -torch.exp(torch.tensor(rng.normal(0, 0.5, (H,)), dtype=f32))
    B = torch.tensor(rng.normal(0, 1, (b, S, N)), dtype=f32)
    C = torch.tensor(rng.normal(0, 1, (b, S, N)), dtype=f32)
    D = torch.tensor(rng.normal(0, 1, (H,)), dtype=f32)
    return [t.requires_grad_() for t in (x, dt, A, B, C, D)]


def test_ssd_function_equals_plain_autograd():
    """At a chunk multiple the Function's forward is ``ssd_scan_plain`` (on
    the CPU): ``y`` and the state equal plain autograd's bit for bit.  Its
    backward is the backward kernel's plain version, a different formula:
    with upstream gradients for both outputs, each input's float32
    gradient lies within 4 times plain float32 autograd's own error
    against float64 autograd, plus 1e-6 of the gradient's magnitude (the
    same float32 terms summed in other orders)."""
    args = _ssd_inputs(2, 32, 3, 8, 4, 0)
    rng = np.random.default_rng(9)
    gy = torch.tensor(rng.normal(0, 1, (2, 32, 3, 8)), dtype=torch.float32)
    gs = torch.tensor(rng.normal(0, 1, (2, 3, 8, 4)), dtype=torch.float32)
    y, state = ops.ssd_scan(*args, chunk=8)
    got = torch.autograd.grad((y, state), args, (gy, gs))
    py, ps = kd.ssd_scan_plain(*args, chunk=8)
    plain = torch.autograd.grad((py, ps), args, (gy, gs))
    assert torch.equal(y, py) and torch.equal(state, ps)
    assert y.grad_fn is not None
    a64 = [t.detach().double().requires_grad_() for t in args]
    y64, s64 = kd.ssd_scan_plain(*a64, chunk=8)
    want = torch.autograd.grad((y64, s64), a64, (gy.double(), gs.double()))
    for name, a, p, w in zip(("x", "dt", "A", "B", "C", "D"), got, plain,
                             want):
        assert a is not None, f"no gradient for {name}"
        err = float((a.double() - w).abs().max())
        limit = kd.f64_tol(float((p.double() - w).abs().max()),
                           float(w.abs().max()))
        assert err <= limit, (name, err, limit)


def _padded_chunked(x, dt, A, B, C, D, *, chunk):
    """The model's ``ssd_chunked`` (plain autograd, independent of the
    kernel's plain version) behind ``ops.ssd_scan``'s padding."""
    S = x.shape[1]
    pad = (-S) % chunk

    def p(t):
        return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

    y, state = ssm.ssd_chunked(p(x), p(dt), A, p(B), p(C), D, chunk=chunk)
    return y[:, :S], state


def test_ssd_function_gives_every_input_a_gradient_through_the_pad():
    """S = 27 pads to 32; only y reaches the loss (the state's upstream
    gradient is None); each input's gradient is non-None and matches the
    model's ``ssd_chunked`` under plain autograd."""
    args = _ssd_inputs(2, 27, 3, 8, 4, 1)
    y, _ = ops.ssd_scan(*args, chunk=8)
    got = torch.autograd.grad(y.square().sum(), args, allow_unused=True)
    yc, _ = _padded_chunked(*args, chunk=8)
    want = torch.autograd.grad(yc.square().sum(), args)
    for name, a, b in zip(("x", "dt", "A", "B", "C", "D"), got, want):
        assert a is not None, f"no gradient for {name}"
        err = float((a - b).abs().max())
        assert err <= GRAD_TOL * float(b.abs().max()), (name, err)


def test_ssd_function_skips_inputs_without_grad():
    """Only x and B want gradients: the others get None and no work."""
    args = [t.detach() for t in _ssd_inputs(1, 16, 2, 4, 4, 2)]
    args[0].requires_grad_()
    args[3].requires_grad_()
    y, _ = ops.ssd_scan(*args, chunk=8)
    gx, gB = torch.autograd.grad(y.sum(), (args[0], args[3]))
    assert gx.shape == args[0].shape and gB.shape == args[3].shape
    with torch.no_grad():
        y2, _ = ops.ssd_scan(*args, chunk=8)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())


def test_mixer_params_get_the_ssd_gradient(monkeypatch):
    """The Mamba-2 mixer's params (w_in, conv_w, dt_bias, A_log, D, w_out)
    through the Function against the same mixer with ``ssd_chunked`` in
    the kernel's place; none is None or all zero."""
    cfg = dataclasses.replace(get_config("mamba2_780m").reduced(),
                              dtype="float32")
    p = tree_map(lambda t: t[0].detach().requires_grad_(),
                 M.init_params(cfg, 0, device="cpu")["layers"]["mixer"])
    x = torch.tensor(np.random.default_rng(3).normal(0, 1, (2, 20, 64)),
                     dtype=torch.float32)
    kw = dict(n_heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim,
              state_dim=cfg.ssm_state, conv_dim=cfg.ssm_conv,
              chunk=cfg.ssd_chunk)
    names = sorted(p)
    y, _ = ssm.mamba2_mixer(p, x, **kw)
    got = torch.autograd.grad(y.square().mean(), [p[n] for n in names])
    monkeypatch.setattr(ssm, "ssd_scan", _padded_chunked)
    yc, _ = ssm.mamba2_mixer(p, x, **kw)
    want = torch.autograd.grad(yc.square().mean(), [p[n] for n in names])
    for n, a, b in zip(names, got, want):
        assert a is not None and float(a.abs().max()) > 0, n
        err = float((a - b).abs().max())
        assert err <= GRAD_TOL * float(b.abs().max()), (n, err)


# ---------------------------------------------------------------------------
# the loss against the reference's
# ---------------------------------------------------------------------------


FAMILIES = ["mamba2_780m", "hymba_1_5b", "deepseek_7b", "minicpm3_4b",
            "qwen2_moe_a2_7b", "llama32_vision_11b", "whisper_large_v3"]


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """The reduced f32 config in both packages, the reference's params
    (a VLM's cross gates set non-zero, 0.5, 0.75, ...), the same params in
    the port, and a batch of (2, 2 attn_chunk + 1) tokens with its stubs."""
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jparams = jax.jit(lambda k: jM.init_params(jcfg, k))(
        jax.random.PRNGKey(0))
    if cfg.family == "vlm":
        gate = jparams["cross"]["gate"]
        vals = 0.5 + 0.25 * jnp.arange(gate.shape[0], dtype=jnp.float32)
        jparams = dict(jparams, cross=dict(jparams["cross"],
                                           gate=vals[:, None]))
    params = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab,
                                    (2, 2 * cfg.attn_chunk + 1)).astype(
                                        np.int32)}
    if cfg.family == "vlm":
        batch["vision"] = rng.normal(0, 1, (2, cfg.vis_seq, cfg.d_model)
                                     ).astype(np.float32)
    if cfg.kind == "encdec":
        batch["frames"] = rng.normal(0, 1, (2, cfg.enc_seq, cfg.d_model)
                                     ).astype(np.float32)
    return jcfg, cfg, jparams, params, batch


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _port_value_and_grad(cfg, params, batch):
    ps = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = M.lm_loss(cfg, ps, _torch_batch(batch))
    grads = torch.autograd.grad(loss, leaves(ps), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves(ps), grads)]
    return float(loss), grads


def _chunked(module, name, monkeypatch):
    """Force flash-chunked attention in ``module``'s forward helper, as
    ``S > 2048`` would (the loss has no switch of its own)."""
    monkeypatch.setattr(module, name, functools.partial(
        getattr(module, name), chunked=True))


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_loss_and_grads_match_the_reference_chunked(arch, monkeypatch):
    """S = 2 x attn_chunk with the attention chunked in both packages."""
    jcfg, cfg, jparams, params, batch = _pair(arch)
    _chunked(jM, "hidden_forward", monkeypatch)
    _chunked(M, "_forward_aux", monkeypatch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jM.lm_loss(jcfg, p, jb)))(jparams)
    got, grads = _port_value_and_grad(cfg, params, batch)
    assert abs(got - float(want)) <= LOSS_RTOL * abs(float(want))
    _assert_tree_close(grads, jgrads, GRAD_TOL, arch)


def test_lm_loss_and_grads_match_the_reference_unchunked():
    jcfg, cfg, jparams, params, batch = _pair("hymba_1_5b")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jM.lm_loss(jcfg, p, jb)))(jparams)
    got, grads = _port_value_and_grad(cfg, params, batch)
    assert abs(got - float(want)) <= LOSS_RTOL * abs(float(want))
    _assert_tree_close(grads, jgrads, GRAD_TOL)


def test_moe_aux_matches_the_reference():
    """Qwen's summed load-balance aux, non-zero, and its share of the
    loss (``0.01 * aux / n_layers``)."""
    jcfg, cfg, jparams, params, batch = _pair("qwen2_moe_a2_7b")
    toks = batch["tokens"][:, :-1]
    _, jaux, _ = jM.hidden_forward(jcfg, jparams, jnp.asarray(toks))
    _, aux = M._forward_aux(cfg, params, torch.tensor(toks))
    assert float(jaux) > 0
    assert abs(float(aux) - float(jaux)) <= LOSS_RTOL * float(jaux)
    hidden, _ = M.hidden_forward(cfg, params, torch.tensor(toks))
    ce = M.chunked_ce(cfg, params, hidden, torch.tensor(batch["tokens"][:, 1:]))
    loss = M.lm_loss(cfg, params, _torch_batch(batch))
    assert float(loss - ce) == pytest.approx(0.01 * float(aux) / cfg.n_layers,
                                             rel=1e-5)


@pytest.mark.parametrize("arch,s,chunk", [
    ("deepseek_7b", 24, 16), ("whisper_large_v3", 21, 8),
    ("deepseek_7b", 8, 2048)])
def test_chunked_ce_matches_the_reference(arch, s, chunk):
    """The loss and its gradients (hidden states and head) with the
    reference's chunk choice: 24 by 16 runs chunks of 12, 21 by 8 chunks of
    7 (Whisper's tied head), 8 by 2048 one chunk."""
    jcfg, cfg, jparams, params, _ = _pair(arch)
    rng = np.random.default_rng(5)
    hidden = rng.normal(0, 1, (2, s, cfg.d_model)).astype(np.float32)
    targets = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)

    def jloss(p, h):
        return jM.chunked_ce(jcfg, p, h, jnp.asarray(targets), chunk=chunk)

    want, (jgp, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jparams, jnp.asarray(hidden))
    ps = tree_map(lambda t: t.detach().requires_grad_(), params)
    h = torch.tensor(hidden, requires_grad=True)
    got = M.chunked_ce(cfg, ps, h, torch.tensor(targets), chunk=chunk)
    head = "embed" if cfg.tie_embeddings else "lm_head"
    gh, gp = torch.autograd.grad(got, (h, ps[head]))
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    for a, b in ((gh, jgh), (gp, jgp[head])):
        b = np.asarray(b)
        assert float(np.abs(_np(a) - b).max()) <= GRAD_TOL * float(
            np.abs(b).max())


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2_780m", "hymba_1_5b",
                                  "qwen2_moe_a2_7b", "whisper_large_v3"])
def test_remat_modes_agree(arch, monkeypatch):
    """``none``, ``full`` and ``dots`` give the same loss and gradients
    bit for bit.  ``full`` recomputes each layer, so the SSD Function's
    forward runs twice a layer; so does ``dots``, which keeps only the
    matmul outputs (the scan is none)."""
    _, cfg, _, params, batch = _pair(arch)
    calls = []
    real = ops.ssd_scan_kernel
    monkeypatch.setattr(ops, "ssd_scan_kernel",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = {}
    for mode in ("none", "full", "dots"):
        calls.clear()
        out[mode] = _port_value_and_grad(
            dataclasses.replace(cfg, remat=mode), params, batch)
        n_ssd = cfg.n_layers if cfg.ssm_heads else 0
        assert len(calls) == (n_ssd if mode == "none" else 2 * n_ssd), mode
    for mode in ("full", "dots"):
        assert out[mode][0] == out["none"][0], mode
        for a, b in zip(out[mode][1], out["none"][1]):
            assert torch.equal(a, b), mode
    with pytest.raises(ValueError, match="remat"):
        M.lm_loss(dataclasses.replace(cfg, remat="some"), params,
                  _torch_batch(batch))


def _ce_chunks(s, chunk=2048):
    c = min(chunk, s)
    while s % c:
        c -= 1
    return s // c


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_checkpoints_only_what_autograd_records(remat, monkeypatch):
    """With grad mode on, as the prefill and serve entries run, a forward
    on params that do not require grad checkpoints nothing: not a layer,
    not a cross-entropy chunk.  The same loss on params that require grad
    checkpoints every layer (Hymba's global ones too) and every chunk."""
    _, cfg, _, params, batch = _pair("hymba_1_5b")
    cfg = dataclasses.replace(cfg, remat=remat)
    calls = []
    real = M.checkpoint
    monkeypatch.setattr(M, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tb = _torch_batch(batch)
    assert torch.is_grad_enabled()
    logits = make_prefill_step(cfg)(params, {"tokens": tb["tokens"][:, :-1]})
    M.lm_loss(cfg, params, tb)
    assert calls == [] and not logits.requires_grad
    ps = tree_map(lambda t: t.detach().requires_grad_(), params)
    M.lm_loss(cfg, ps, tb)
    assert len(calls) == cfg.n_layers + _ce_chunks(tb["tokens"].shape[1] - 1)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["deepseek_7b", "mamba2_780m",
                                  "qwen2_moe_a2_7b"])
def test_train_step_matches_the_reference(arch, microbatches):
    """Two steps of ``make_train_step`` from the same params on the same
    pipeline batches (4 sequences of 32 tokens): the losses, then the
    params and the AdamW state after each step.  Step 0's learning rate is
    0, so step 0 leaves the params as they were and step 1 moves them."""
    jcfg, cfg, jparams, params, _ = _pair(arch)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    jstep, jopt = jsteps.make_train_step(jcfg, microbatches=microbatches)
    jstep = jax.jit(jstep)
    step, opt = make_train_step(cfg, microbatches=microbatches)
    jstate, state = jopt.init(jparams), opt.init(params)
    for i in range(2):
        toks = batch_at(data, i)["tokens"]
        jparams, jstate, jloss = jstep(jparams, jstate,
                                       {"tokens": jnp.asarray(toks)})
        new, state, loss = step(params, state, {"tokens": torch.tensor(toks)})
        assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
        moved = any(not torch.equal(a, b)
                    for a, b in zip(leaves(new), leaves(params)))
        assert moved == (i == 1)
        params = new
        assert int(state.step) == int(jstate.step) == i + 1
        _assert_tree_close(state.mu, jstate.mu, GRAD_TOL, "mu")
        _assert_tree_close(state.nu, jstate.nu, 2 * GRAD_TOL, "nu")
        for a, b in zip(leaves(params), jax.tree.leaves(jparams)):
            # step 1 moves each param by at most 2 lr (Adam's |delta| <= 1
            # per unit, plus decay); lr = 3e-4 x warmup_cosine(1) = 1.5e-6
            assert float(np.abs(_np(a) - np.asarray(b)).max()) <= 1e-6


# a gradient that lies near a bf16 rounding boundary rounds one way in one
# package and the other way in the other: adjacent bf16 values differ by at
# most 2^-7 of their magnitude.  The cast (``grad_dtype``) rounds once, the
# two-part accumulator (``accum_dtype``) up to twice, so the first moment
# lies within 2^-6 of its leaf's max and the second (a square) within 2^-5.
BF16_MU_TOL = 2.0 ** -6
BF16_NU_TOL = 2.0 ** -5


@pytest.mark.parametrize("option,microbatches", [("grad_dtype", 1),
                                                 ("accum_dtype", 2)])
def test_train_step_bf16_options_match_the_reference(option, microbatches,
                                                     monkeypatch):
    """``grad_dtype`` (a single batch's gradients cast before the update)
    and ``accum_dtype`` (the microbatch accumulators) at bfloat16, against
    the reference's step with the same option over two steps: the update
    receives bfloat16 gradients, the losses agree as above, the moments
    within the bf16 limits above and the params after step 1 within 1e-6."""
    jcfg, cfg, jparams, params, _ = _pair("deepseek_7b")
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    jstep, jopt = jsteps.make_train_step(jcfg, microbatches=microbatches,
                                         **{option: jnp.bfloat16})
    jstep = jax.jit(jstep)
    step, opt = make_train_step(cfg, microbatches=microbatches,
                                **{option: torch.bfloat16})
    seen = []
    real = AdamW.update
    monkeypatch.setattr(
        AdamW, "update", lambda self, grads, *a, **k: seen.append(
            {g.dtype for g in leaves(grads)}) or real(self, grads, *a, **k))
    jstate, state = jopt.init(jparams), opt.init(params)
    for i in range(2):
        toks = batch_at(data, i)["tokens"]
        jparams, jstate, jloss = jstep(jparams, jstate,
                                       {"tokens": jnp.asarray(toks)})
        params, state, loss = step(params, state,
                                   {"tokens": torch.tensor(toks)})
        assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
        _assert_tree_close(state.mu, jstate.mu, BF16_MU_TOL, "mu")
        _assert_tree_close(state.nu, jstate.nu, BF16_NU_TOL, "nu")
    assert seen == [{torch.bfloat16}] * 2
    for a, b in zip(leaves(params), jax.tree.leaves(jparams)):
        assert float(np.abs(_np(a) - np.asarray(b)).max()) <= 1e-6


@pytest.mark.parametrize("rows,microbatches", [(8, 3), (5, 4)])
def test_train_step_refuses_an_uneven_microbatch_split(rows, microbatches):
    """A batch whose rows do not divide into the microbatches is refused,
    as the reference's reshape refuses it, before any gradient is taken."""
    jcfg, cfg, jparams, params, _ = _pair("deepseek_7b")
    toks = batch_at(DataConfig(vocab=cfg.vocab, seq_len=16,
                               global_batch=rows), 0)["tokens"]
    step, opt = make_train_step(cfg, microbatches=microbatches)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, opt.init(params), {"tokens": torch.tensor(toks)})
    jstep, jopt = jsteps.make_train_step(jcfg, microbatches=microbatches)
    with pytest.raises(TypeError):
        jstep(jparams, jopt.init(jparams), {"tokens": jnp.asarray(toks)})
