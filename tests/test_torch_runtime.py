"""The port's training runtime against the reference's: the data pipeline,
the checkpointer, the straggler detector, fault tolerance, the serving
scheduler and the training loop.

* ``batch_at`` and ``Pipeline`` give the reference's tokens for several
  seeds, steps and hosts;
* the checkpointer: the reference's cases (round trip, corruption, gc,
  async, bf16), the reference's leaf paths, and checkpoints that cross
  both ways — the reference writes a reduced model's ``{"params", "opt"}``
  and the port restores equal tensors, then the reverse;
* ``StragglerDetector``, ``FaultTolerantCluster`` / ``plan_restart`` and
  ``BatchScheduler`` make the reference's decisions on the same seeded
  streams;
* ``train("deepseek_7b", reduced=True, ...)`` on the CPU: the loss falls
  and a restart from the step-15 checkpoint replays the last loss within
  the reference's own rtol 1e-4 (``tests/test_integration.py``); two
  microbatches take the same steps as one; the CLI.
"""

import dataclasses
import json
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch.steps import make_optimizer as j_make_optimizer  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro.runtime import scheduler as jsched  # noqa: E402
from repro.runtime import straggler as jstrag  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer, leaf_paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402
from repro_torch.launch.steps import make_optimizer  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import leaves  # noqa: E402
from repro_torch.runtime import fault_tolerance as ft  # noqa: E402
from repro_torch.runtime import scheduler as sched  # noqa: E402
from repro_torch.runtime import straggler as strag  # noqa: E402

# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n_hosts", [(1234, 1), (7, 2), (99, 4)])
def test_batch_at_matches_the_reference(seed, n_hosts):
    for host in range(n_hosts):
        kw = dict(vocab=50280, seq_len=48, global_batch=8, seed=seed,
                  n_hosts=n_hosts, host_id=host)
        cfg, jcfg = pipe.DataConfig(**kw), jpipe.DataConfig(**kw)
        assert cfg.host_batch == jcfg.host_batch == 8 // n_hosts
        for step in (0, 1, 17, 1000):
            got = pipe.batch_at(cfg, step)["tokens"]
            want = jpipe.batch_at(jcfg, step)["tokens"]
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)


def test_pipeline_matches_the_reference():
    kw = dict(vocab=311, seq_len=16, global_batch=4)
    p, jp = pipe.Pipeline(pipe.DataConfig(**kw), start_step=5), \
        jpipe.Pipeline(jpipe.DataConfig(**kw), start_step=5)
    try:
        for _ in range(4):
            np.testing.assert_array_equal(next(p)["tokens"],
                                          next(jp)["tokens"])
        assert p.step == jp.step == 9
    finally:
        p.close()
        jp.close()


def test_data_reference_cases():
    """The reference's TestData cases, on the port's pipeline."""
    cfg = pipe.DataConfig(vocab=1000, seq_len=16, global_batch=4)
    a = pipe.batch_at(cfg, 7)["tokens"]
    np.testing.assert_array_equal(a, pipe.batch_at(cfg, 7)["tokens"])
    assert not np.array_equal(a, pipe.batch_at(cfg, 8)["tokens"])
    c0 = pipe.DataConfig(vocab=1000, seq_len=16, global_batch=8, n_hosts=2)
    c1 = dataclasses.replace(c0, host_id=1)
    assert not np.array_equal(pipe.batch_at(c0, 0)["tokens"],
                              pipe.batch_at(c1, 0)["tokens"])
    t = pipe.batch_at(pipe.DataConfig(vocab=311, seq_len=32, global_batch=4),
                      3)["tokens"]
    assert t.min() >= 0 and t.max() < 311


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.arange(8.0),
            "b": {"c": torch.ones((2, 3), dtype=torch.bfloat16)}}
    ck.save(5, tree, blocking=True)
    assert ck.latest_complete() == 5
    like = {"a": torch.zeros(8), "b": {"c": torch.zeros((2, 3),
                                                        dtype=torch.bfloat16)}}
    out = ck.restore(5, like)
    assert torch.equal(out["a"], torch.arange(8.0))
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"], tree["b"]["c"])


def test_corruption_detected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.arange(4.0)}
    ck.save(1, tree, blocking=True)
    next(tmp_path.glob("step_*/*a*.npy")).write_bytes(b"garbage" * 10)
    with pytest.raises(IOError):
        ck.restore(1, tree)


def test_shape_mismatch_refused(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(2, {"a": torch.arange(4.0)}, blocking=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(2, {"a": torch.zeros(5)})


def test_gc_keeps_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"a": torch.zeros(2)}, blocking=True)
    assert ck.latest_complete() == 4
    assert len(sorted(tmp_path.glob("step_*"))) == 2


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(9, {"a": torch.ones(16)})
    ck.wait()
    assert ck.latest_complete() == 9


def test_async_save_error_reaches_wait(tmp_path):
    """A failure in the background write is raised by ``wait``."""
    ck = Checkpointer(str(tmp_path))
    (tmp_path / "step_0000000003").mkdir()  # the rename target exists
    (tmp_path / "step_0000000003" / "x").write_text("x")
    ck.save(3, {"a": torch.ones(2)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # reported once


def _reduced(arch="deepseek_7b"):
    return j_get_config(arch).reduced(), get_config(arch).reduced()


def test_leaf_paths_are_the_references():
    """``{"params", "opt": AdamWState}`` of a reduced bf16 model: the
    port's paths are ``jax.tree_util``'s, in its order."""
    jcfg, cfg = _reduced("hymba_1_5b")
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    jtree = {"params": jparams, "opt": j_make_optimizer(jcfg).init(jparams)}
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    want = ["/".join(str(k) for k in path) for path, _ in flat]
    params = M.init_params(cfg, 0, device="cpu")
    tree = {"params": params, "opt": make_optimizer(cfg).init(params)}
    got = [p for p, _ in leaf_paths(tree)]
    assert got == want
    assert "['opt']/.step" in got and "['params']/['embed']" in got


def _assert_trees_equal(port_tree, jtree):
    for (p, a), b in zip(leaf_paths(port_tree), jax.tree.leaves(jtree)):
        b = np.asarray(b)
        if a.dtype == torch.bfloat16:
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          b.view(np.int16), err_msg=p)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=p)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """The reference writes a reduced bf16 model's params and a 1-step
    AdamW state; the port restores every leaf equal, in the like's dtype
    and shape."""
    jcfg, cfg = _reduced()
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(1))
    jopt = j_make_optimizer(jcfg)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jparams)
    jparams2, jstate = jopt.update(grads, jopt.init(jparams), jparams, 1.0)
    jtree = {"params": jparams2, "opt": jstate}
    JCheckpointer(str(tmp_path)).save(7, jtree, blocking=True)
    params = M.init_params(cfg, 0, device="cpu")
    like = {"params": params, "opt": make_optimizer(cfg).init(params)}
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_complete() == 7
    out = ck.restore(7, like)
    assert int(out["opt"].step) == 1 and out["opt"].step.dtype == torch.int32
    assert type(out["opt"]) is type(like["opt"])
    _assert_trees_equal(out, jtree)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """The reverse: the port's params and state after one train step,
    restored by the reference into its own tree."""
    jcfg, cfg = _reduced()
    from repro_torch.launch.steps import make_train_step

    params = M.init_params(cfg, 0, device="cpu")
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    toks = pipe.batch_at(pipe.DataConfig(vocab=cfg.vocab, seq_len=16,
                                         global_batch=2), 0)["tokens"]
    params, state, _ = step(params, state, {"tokens": torch.tensor(toks)})
    tree = {"params": params, "opt": state}
    ck_port = Checkpointer(str(tmp_path))
    ck_port.save(4, tree)  # in the background
    ck_port.wait()
    ck = JCheckpointer(str(tmp_path))
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(0))
    jlike = {"params": jparams, "opt": j_make_optimizer(jcfg).init(jparams)}
    out = ck.restore(4, jlike)
    assert int(out["opt"].step) == 1
    assert out["params"]["embed"].dtype == jnp.bfloat16
    _assert_trees_equal(tree, out)
    manifest = json.loads((tmp_path / "step_0000000004" /
                           "manifest.json").read_text())
    assert manifest["shards"]["['params']/['embed']"]["dtype"] == "bfloat16"
    assert manifest["shards"]["['opt']/.step"]["dtype"] == "int32"


# ---------------------------------------------------------------------------
# the control plane: the reference's decisions on the same streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_decisions_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    det, jdet = strag.StragglerDetector(n_hosts=6, patience=3), \
        jstrag.StragglerDetector(n_hosts=6, patience=3)
    seen = 0
    for step in range(60):
        times = list(1.0 + 0.05 * rng.standard_normal(6))
        if step >= 20:
            times[seed] *= 1.5 + seed  # one host degrades
        got, want = det.observe(times), jdet.observe(times)
        assert got == want, step
        seen += len(got)
    assert seen > 0
    assert det.mean == jdet.mean and det.strikes == jdet.strikes


def test_fault_tolerance_matches_the_reference():
    rng = random.Random(3)
    t = [0.0]
    cl = ft.FaultTolerantCluster(n_hosts=8, timeout_s=5, clock=lambda: t[0])
    jcl = jft.FaultTolerantCluster(n_hosts=8, timeout_s=5, clock=lambda: t[0])
    for _ in range(200):
        t[0] += rng.uniform(0, 3)
        for h in range(8):
            if rng.random() < 0.6:
                cl.heartbeat(h)
                jcl.heartbeat(h)
        assert cl.check() == jcl.check()
        assert cl.alive_count == jcl.alive_count
    for alive in range(0, 70, 3):
        for spare in (0, 2):
            for ckpt in (None, 500):
                kw = dict(alive_hosts=alive, hosts_per_replica=8,
                          base_mesh=(16, 16), spare_hosts=spare,
                          latest_checkpoint=ckpt)
                got, want = ft.plan_restart(**kw), jft.plan_restart(**kw)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_scheduler_matches_the_reference():
    """A seeded stream of submissions, admissions and ticks, preemption
    included: the same cohorts, completions and preemptions."""
    rng = random.Random(5)
    kw = dict(n_slots=3, max_seq=4096, preempt_after=20, max_wait_steps=8)
    s, js = sched.BatchScheduler(**kw), jsched.BatchScheduler(**kw)
    rid = 0
    for _ in range(400):
        if rng.random() < 0.3:
            plen, new = rng.randint(1, 64), rng.randint(1, 120)
            s.submit(sched.Request(rid=rid, prompt_len=plen,
                                   max_new_tokens=new))
            js.submit(jsched.Request(rid=rid, prompt_len=plen,
                                     max_new_tokens=new))
            rid += 1
        assert [r.rid for r in s.admit()] == [r.rid for r in js.admit()]
        assert s.tick() == js.tick()
        assert s.utilization == js.utilization
    assert s.completed == js.completed and s.preempted == js.preempted
    assert s.preempted > 0
    with pytest.raises(ValueError):
        s.submit(sched.Request(rid=-1, prompt_len=4000, max_new_tokens=100))


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------


def test_loss_decreases_and_restart_is_exact(tmp_path):
    """The reference's ``TestTrainLoop`` on the port, on the CPU."""
    kw = dict(steps=30, reduced=True, seq_len=64, global_batch=4,
              ckpt_dir=str(tmp_path), log_every=100, device="cpu")
    losses = train("deepseek_7b", ckpt_every=15, **kw)
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])  # learning
    assert Checkpointer(str(tmp_path)).latest_complete() == 15
    resumed = train("deepseek_7b", ckpt_every=100, resume=True, **kw)
    assert len(resumed) == 14  # steps 16..29
    np.testing.assert_allclose(resumed[-1], losses[-1], rtol=1e-4,
                               err_msg="restart-replay diverged")
    np.testing.assert_allclose(resumed, losses[16:], rtol=1e-4)


def test_train_microbatches_take_the_same_steps():
    """``train(microbatches=2)`` takes the steps of one whole batch: the
    halves hold equal tokens, and each half's loss and gradient weighs
    1/2.  A batch the microbatches do not divide is refused."""
    kw = dict(steps=3, seq_len=32, global_batch=4, device="cpu",
              log_every=100)
    whole = train("deepseek_7b", **kw)
    halves = train("deepseek_7b", microbatches=2, **kw)
    np.testing.assert_allclose(halves, whole, rtol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        train("deepseek_7b", microbatches=3, **kw)


def test_train_cli(capsys):
    train_main(["--arch", "qwen2_moe_a2_7b", "--steps", "3", "--seq-len",
                "32", "--global-batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    steps = [float(line.split()[-1]) for line in out
             if line.startswith("step ")]
    assert len(steps) == 2  # step 0 and the last
    assert out[-1].startswith("first loss") and all(np.isfinite(steps))


def test_train_vlm_and_encdec_stubs():
    """The bf16 zero stubs reach the VLM's and Whisper's cross layers."""
    for arch in ("llama32_vision_11b", "whisper_large_v3"):
        losses = train(arch, steps=2, seq_len=16, global_batch=2,
                       device="cpu", log_every=100)
        assert len(losses) == 2 and np.isfinite(losses).all()


def test_train_refuses_without_a_device_argument_on_a_cpu_machine():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train("deepseek_7b", steps=1)


def test_interop_carries_the_adamw_state():
    jcfg, cfg = _reduced("mamba2_780m")
    jparams = jM.init_params(jcfg, jax.random.PRNGKey(2))
    jstate = j_make_optimizer(jcfg).init(jparams)
    state = interop.adamw_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                           device="cpu")
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    assert len(leaves(state.mu)) == len(jax.tree.leaves(jstate.mu))
    assert all(m.dtype == torch.float32 for m in leaves(state.nu))
