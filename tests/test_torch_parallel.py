"""The port's parallel layer against the reference's.

* ``partition_spec`` and ``rules_for``: the same entries for every leaf of
  every full config's param and cache specs, under every step's rules, on
  the reference's meshes ``(16, 16)`` and ``(2, 16, 16)`` and the port's
  ``(32, 8)`` and ``(2, 32, 8)`` (the reference resolves against a jax
  ``AbstractMesh``, the port against the sizes);
* ``placements`` and ``constrain`` on a 4-rank fake mesh, against the same
  slices of plain tensors;
* ``compressed_mean``: the reference under ``shard_map`` on 2 host devices
  (a subprocess) against the port over a 2-rank gloo group (two
  processes), equal bit for bit;
* the planned einsum (``parallel.spmd``) against ``torch.einsum``.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import serving as RS  # noqa: E402
from repro.parallel import sharding as RSH  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import serving as S  # noqa: E402
from repro_torch.models.params import leaves  # noqa: E402
from repro_torch.parallel import sharding as SH  # noqa: E402
from repro_torch.parallel.constraints import (  # noqa: E402
    constrain,
    mesh_rules,
    split_rows,
)

REPO = Path(__file__).resolve().parents[1]
MESHES = {
    "ref_16x16": ((16, 16), ("data", "model")),
    "ref_2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "port_32x8": ((32, 8), ("data", "model")),
    "port_2x32x8": ((2, 32, 8), ("pod", "data", "model")),
}
STEPS = (("train", False), ("prefill", False), ("decode", False),
         ("decode", True))


def _ref_entries(pspec) -> tuple:
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in pspec)


def _jax_leaves(tree):
    from repro.models.params import P

    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_partition_spec_equals_reference(arch, mesh_key):
    shape, names = MESHES[mesh_key]
    amesh = jax.sharding.AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    trees = [(leaves(M.build_param_specs(cfg)),
              _jax_leaves(RM.build_param_specs(rcfg)))]
    for sh in ("decode_32k", "long_500k"):
        B, L = SHAPES[sh].global_batch, SHAPES[sh].seq_len
        trees.append((leaves(S.build_cache_specs(cfg, B, L)),
                      _jax_leaves(RS.build_cache_specs(rcfg, B, L))))
    n = 0
    for step, long in STEPS:
        rules = SH.rules_for(step, long_context=long)
        rrules = RSH.rules_for(step, long_context=long)
        assert rules.rules == rrules.rules
        for mine, theirs in trees:
            assert len(mine) == len(theirs)
            for p, q in zip(mine, theirs):
                assert p.shape == q.shape and p.axes == q.axes
                want = _ref_entries(RSH.partition_spec(q.shape, q.axes,
                                                       amesh, rrules))
                assert SH.partition_spec(p.shape, p.axes, sizes,
                                         rules) == want, (p, step, long)
                n += 1
    assert n >= 40


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
def test_override_and_batch_sharding_follow_the_reference(mesh_key):
    shape, names = MESHES[mesh_key]
    amesh = jax.sharding.AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    kw = {"batch": ("data", "model"), "heads": (), "seq": ("model",)}
    rules, rrules = SH.ShardingRules().override(**kw), \
        RSH.ShardingRules().override(**kw)
    assert rules.rules == rrules.rules
    for logical in ("batch", "heads", "seq", "embed", "cache_seq", None):
        assert rules.mesh_axes_for(logical, sizes) == \
            rrules.mesh_axes_for(logical, amesh)
    for dims, axes in (((256, 4096, 64), ("batch", "seq", None)),
                       ((512, 128), ("embed", "embed")),
                       ((7, 64), ("batch", "heads"))):
        assert SH.partition_spec(dims, axes, sizes, rules) == _ref_entries(
            RSH.partition_spec(dims, axes, amesh, rrules))


@pytest.fixture(scope="module")
def mesh4():
    from repro_torch.launch.mesh import fake_mesh

    return fake_mesh((2, 2), ("data", "model"))


def test_placements_shard_a_dim_over_two_axes_major_to_minor(mesh4):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    assert SH.placements((("data", "model"),), mesh4) == (Shard(0), Shard(0))
    assert SH.placements((None, "model"), mesh4) == (Replicate(), Shard(1))
    assert SH.placements((), mesh4) == (Replicate(), Replicate())
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for spec in ((("data", "model"),), ("data", "model"), (None, "data")):
        d = distribute_tensor(x, mesh4, SH.placements(spec, mesh4))
        assert tuple(d.to_local().shape) == SH.local_shape(x.shape, spec,
                                                           mesh4)
        # rank 0 holds the first block of every sharded dim
        want = x[tuple(slice(0, n) for n in d.to_local().shape)]
        assert torch.equal(d.to_local(), want)


def test_constrain_is_identity_without_a_mesh_or_a_dtensor(mesh4):
    x = torch.randn(4, 6)
    assert constrain(x, "batch", None) is x
    with mesh_rules(mesh4, SH.ShardingRules()):
        assert constrain(x, "batch", None) is x


def test_constrain_redistributes_to_the_rules_placements(mesh4):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = torch.randn(8, 4, 6)
    d = distribute_tensor(x, mesh4, [Replicate(), Replicate()])
    rules = SH.ShardingRules().override(seq=("model",))
    with mesh_rules(mesh4, rules):
        c = constrain(d, "batch", "seq", None)
        assert constrain(c, "batch", "seq", None) is c
    assert tuple(c.placements) == (Shard(0), Shard(1))
    # replicated -> sharded is each rank's slice: rank 0's block of x
    assert torch.equal(c.to_local(), x[:4, :2])
    # the same computation on the plain tensor and on rank 0's shard
    y = torch.tanh(c * 2.0 + 1.0).to_local()
    assert torch.equal(y, torch.tanh(x * 2.0 + 1.0)[:4, :2])


def test_split_rows_plain_is_the_reference_reshape_and_dtensor_local(mesh4):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = torch.arange(8 * 3).reshape(8, 3)
    assert torch.equal(split_rows(x, 2), x.reshape(2, 4, 3))
    with pytest.raises(ValueError):
        split_rows(x, 3)
    d = distribute_tensor(x, mesh4, [Shard(0), Replicate()])
    s = split_rows(d, 2)
    assert tuple(s.shape) == (2, 4, 3)
    assert tuple(s.placements) == (Shard(1), Replicate())
    # rank 0's rows 0..3 split into its two parts, no row moved
    assert torch.equal(s.to_local(), x[:4].reshape(2, 2, 3))


@pytest.mark.parametrize("eq,shapes,pls", [
    ("bsd,dhk->bshk", [(4, 6, 8), (8, 2, 3)], [(0, None), (None, 1)]),
    ("bhqd,bhkd->bhqk", [(4, 2, 5, 3), (4, 2, 7, 3)], [(0, 1), (0, 1)]),
    ("gtke,gtkc->gtec", [(2, 6, 2, 4), (2, 6, 2, 6)], [(0, None), (0, 3)]),
    ("bsd,vd->bsv", [(4, 3, 6), (10, 6)], [(0, None), (None, 0)]),
    ("bsd,dk->bsk", [(4, 3, 6), (6, 5)], [(0, 2), (None, 0)]),
])
def test_planned_einsum_matches_torch_einsum(mesh4, eq, shapes, pls):
    """Rank 0's shard of the planned einsum equals the same block of
    ``torch.einsum`` on the plain operands; a result left ``Partial`` on a
    mesh dim is rank 0's partial sum, the einsum over its slice of the
    contracted letter.  (A fake group moves no data, so the operands here
    are placed where the plan keeps or slices them.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel.spmd import sharded_einsum

    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn(s, generator=gen, dtype=torch.float64) for s in shapes]
    ds = [distribute_tensor(x, mesh4, [Replicate() if p is None else
                                       Shard(p) for p in pl])
          for x, pl in zip(xs, pls)]
    got = sharded_einsum(eq, *ds)
    ins, out = eq.split("->")[0].split(","), eq.split("->")[1]
    cut = {}  # letter -> rank 0's extent
    for sub, x, pl in zip(ins, xs, pls):
        for m, p in enumerate(pl):
            if p is not None:
                cut[sub[p]] = x.shape[p] // mesh4.size(m)
    parts = [x[tuple(slice(0, cut.get(c, n)) for c, n in zip(sub, x.shape))]
             for sub, x in zip(ins, xs)]
    want = torch.einsum(eq, *parts)
    assert tuple(got.shape) == tuple(torch.einsum(eq, *xs).shape)
    torch.testing.assert_close(got.to_local(), want, rtol=1e-12, atol=1e-12)
    partial = any(isinstance(p, Partial) for p in got.placements)
    assert partial == any(c not in out for c in cut)


_REF_MEAN = """
import os, sys, json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.optim.grad_compress import compressed_mean
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
g = np.load(sys.argv[1])
mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
out = jax.jit(shard_map(lambda t: compressed_mean(t[0], "x")[None],
                        mesh=mesh, in_specs=P("x"), out_specs=P("x")))(
    jnp.asarray(g, dtype=sys.argv[3]))
np.save(sys.argv[2], np.asarray(out.astype(jnp.float32)))
"""

_PORT_MEAN = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.optim.grad_compress import compressed_mean
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="file://" + sys.argv[2],
                        rank=rank, world_size=2)
g = torch.from_numpy(np.load(sys.argv[3])[rank]).to(getattr(torch, sys.argv[5]))
out = compressed_mean(g)
assert out.dtype == g.dtype and out.shape == g.shape
np.save(sys.argv[4] + f"{rank}.npy", out.float().numpy())
dist.destroy_process_group()
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env.update(extra)
    return env


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_mean_equals_shard_map_bit_for_bit(tmp_path, dtype):
    rng = np.random.default_rng(7)
    g = rng.standard_normal((2, 33, 17)).astype(np.float32) * np.array(
        [1.0, 3.0], np.float32)[:, None, None]
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        g = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
    np.save(tmp_path / "g.npy", g)
    ref = subprocess.run(
        [sys.executable, "-c", _REF_MEAN, str(tmp_path / "g.npy"),
         str(tmp_path / "ref.npy"), dtype],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=2"),
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    rdv = tmp_path / "rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PORT_MEAN, str(r), str(rdv),
         str(tmp_path / "g.npy"), str(tmp_path / "port"), dtype],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO) for r in (0, 1)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, out + err
    want = np.load(tmp_path / "ref.npy")
    for r in (0, 1):
        got = np.load(tmp_path / f"port{r}.npy")
        assert got.tobytes() == want[r].tobytes()
    # every rank holds the same mean
    assert np.load(tmp_path / "port0.npy").tobytes() == \
        np.load(tmp_path / "port1.npy").tobytes()


def test_grad_compress_docstring_names_compressed_mean():
    from repro_torch.optim import grad_compress

    assert "waits" not in grad_compress.__doc__
    assert callable(grad_compress.compressed_mean)


def test_rules_for_json_roundtrip():
    """The rule sets a record keeps are plain tuples of axis names."""
    for step, long in STEPS:
        r = SH.rules_for(step, long_context=long).rules
        assert json.loads(json.dumps(r)) == {k: list(v) for k, v in
                                             r.items()}


def test_the_three_constrain_sites_pin_the_residual_and_the_loss(mesh4):
    """Under a registered mesh the model's constrain sites run: one a
    layer of the stack and the two of the loss."""
    import repro_torch.models.model as mm

    calls = []
    real = mm.constrain

    def spy(x, *logical):
        calls.append(logical)
        return real(x, *logical)

    cfg = get_config("deepseek_7b").reduced()
    params = M.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 9))
    mm.constrain = spy
    try:
        with mesh_rules(mesh4, SH.ShardingRules()):
            M.lm_loss(cfg, params, {"tokens": tokens})
    finally:
        mm.constrain = real
    assert calls.count(("batch", "seq", None)) == cfg.n_layers
    assert ("batch", None, None) in calls
    assert ("batch", None, "vocab") in calls


def test_dedent_helpers_are_valid_python():
    compile(textwrap.dedent(_REF_MEAN), "ref", "exec")
    compile(textwrap.dedent(_PORT_MEAN), "port", "exec")


def test_per_head_gqa_runs_each_head_block_locally(mesh4):
    """Query and key heads both sharded on the model axis: rank 0's output
    is the plain attention's first head block (its query heads read its
    key head), and the global shape is the queries'."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.models.layers import dense_attention
    from repro_torch.parallel.spmd import per_head

    gen = torch.Generator().manual_seed(5)
    q = torch.randn(4, 6, 4, 3, generator=gen, dtype=torch.float64)
    k = torch.randn(4, 6, 2, 3, generator=gen, dtype=torch.float64)
    v = torch.randn(4, 6, 2, 3, generator=gen, dtype=torch.float64)
    pl = [Shard(0), Shard(2)]
    out = per_head(dense_attention, *(distribute_tensor(t, mesh4, pl)
                                      for t in (q, k, v)), causal=True)
    want = dense_attention(q, k, v, causal=True)
    assert tuple(out.shape) == tuple(want.shape)
    assert tuple(out.placements) == (Shard(0), Shard(2))
    torch.testing.assert_close(out.to_local(), want[:2, :, :2], rtol=1e-12,
                               atol=1e-12)
    # replicated key heads with sharded query heads: expanded, then sliced
    out = per_head(dense_attention, distribute_tensor(q, mesh4, pl),
                   k, v, causal=True)
    torch.testing.assert_close(out.to_local(), want[:2, :, :2], rtol=1e-12,
                               atol=1e-12)


def test_take_rows_gathers_the_local_vocab_slice(mesh4):
    from torch.distributed.tensor import (
        Partial,
        Replicate,
        Shard,
        distribute_tensor,
    )

    from repro_torch.parallel.spmd import take_rows

    table = torch.arange(10 * 4, dtype=torch.float32).reshape(10, 4)
    idx = torch.tensor([[0, 7, 4], [9, 1, 5]])
    assert torch.equal(take_rows(table, idx), table[idx])
    # (a fake group moves no data: the table is sharded on its vocab alone)
    dt = distribute_tensor(table, mesh4, [Replicate(), Shard(0)])
    di = distribute_tensor(idx, mesh4, [Shard(0), Replicate()])
    out = take_rows(dt, di)
    assert tuple(out.shape) == (2, 3, 4)
    assert tuple(out.placements) == (Shard(0), Partial())
    # rank 0: the first row of idx, vocab rows 0..4 kept, the rest zero
    want = table[idx[:1]] * (idx[:1] < 5)[..., None]
    assert torch.equal(out.to_local(), want)


def test_shard_local_runs_the_causal_conv_per_channel_block(mesh4):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.ssm import causal_conv1d
    from repro_torch.parallel.spmd import shard_local

    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4, 7, 6, generator=gen, dtype=torch.float64)
    w = torch.randn(4, 6, generator=gen, dtype=torch.float64)
    y0, s0 = causal_conv1d(x, w)
    y, s = shard_local(causal_conv1d,
                       (distribute_tensor(x, mesh4, [Shard(0), Replicate()]),
                        distribute_tensor(w, mesh4, [Replicate(), Shard(1)]),
                        None), ("b.c", ".c", "b.c"), ("b.c", "b.c"))
    assert tuple(y.placements) == (Shard(0), Shard(2))
    assert tuple(y.shape) == tuple(y0.shape)
    torch.testing.assert_close(y.to_local(), y0[:2, :, :3], rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(s.to_local(), s0[:2, :, :3], rtol=1e-12,
                               atol=1e-12)
