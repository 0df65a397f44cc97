"""The model's operations over DTensors where DTensor's own rules fall
short: einsums planned as GSPMD plans a ``dot_general``, per-shard calls of
operations that are independent along some dims, and a row gather from a
vocab-sharded table.  On plain tensors each is the plain operation itself.

**Einsums.**  DTensor runs an einsum as the permutes, reshapes and batched matmul that
``torch.einsum`` decomposes into, and propagates placements through each:
a batch dim merged from two dims sharded on two mesh dims becomes a
strided shard that the matmul's rules refuse, and a split of a sharded dim
that does not divide is refused outright.  :func:`sharded_einsum` plans
the whole contraction instead.  For each mesh dim it picks one subscript
letter to shard over it (or none), the one whose layout costs the least
time, its moved bytes at the axis's link rate plus its FLOPs at the H100's
peak (a letter left whole is computed by every device on the axis):

* the letters it weighs are those some operand is already sharded on
  there: a plan moves shards, it does not cut new ones, since DTensor
  cannot later merge a dim split where no input was;
* an operand already sharded on that letter keeps its shards;
* an operand that holds the letter but is replicated on the mesh dim takes
  its slice (no communication);
* an operand sharded on another letter is redistributed (an all-gather,
  or an all-to-all onto the chosen letter);
* a contracted letter leaves the result ``Partial`` on that mesh dim (the
  all-reduce is charged to the plan).

The operands' local shards are then contracted by ``torch.einsum`` and the
result is wrapped with the planned placements.  Plain tensors mixed in are
replicated.  :func:`dtensor_einsum` installs it as ``torch.einsum``, and a
matmul of a DTensor (``@``, ``torch.matmul``) as the einsum it is, for the
duration of a trace; on plain tensors both are torch's own.

**Per-shard calls.**  :func:`shard_local` runs a function on the local
shards of its tensors when it is independent along the dims the caller
names (attention along the batch and heads, the depthwise causal conv along
the batch and channels): those dims keep their shards, every other dim is
gathered first, and the outputs are wrapped back.  This is what GSPMD does
with such a computation, and it keeps a block loop's many small operations
off DTensor's dispatch.  :func:`per_head` is attention's case.

**Row gather.**  :func:`take_rows` is ``table[idx]``; on a DTensor table
each device gathers the rows of its vocab slice and zeroes the others, and
the result is ``Partial`` over the vocab's mesh dims (the masked gather
GSPMD emits for a sharded gather).
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.configs.h100 import (
    IB_BW,
    INTRA_HOST_AXES,
    NVLINK_BW,
    PEAK_FLOPS,
)

_EINSUM = torch.einsum


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor" and hasattr(x, "device_mesh")


def _parse(eq: str, n: int) -> tuple[list[str], str]:
    eq = eq.replace(" ", "")
    if "..." in eq or "->" not in eq:
        raise ValueError(f"sharded_einsum wants explicit subscripts: {eq!r}")
    lhs, out = eq.split("->")
    ins = lhs.split(",")
    if len(ins) != n:
        raise ValueError(f"{eq!r} names {len(ins)} operands, got {n}")
    return ins, out


def _local_bytes(t) -> int:
    loc = t.to_local()
    return loc.numel() * loc.element_size()


def sharded_einsum(eq: str, *operands):
    """``torch.einsum(eq, *operands)`` with DTensor operands planned as a
    whole (module docstring); plain operands only: ``torch.einsum``."""
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    if not any(_is_dtensor(o) for o in operands):
        return _EINSUM(eq, *operands)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    ins, out = _parse(eq, len(operands))
    mesh = next(o.device_mesh for o in operands if _is_dtensor(o))
    ops = []
    for o in operands:
        if not _is_dtensor(o):
            o = DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if any(isinstance(p, Partial) for p in o.placements):
            o = o.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                      else p for p in o.placements])
        ops.append(o)
    size: dict[str, int] = {}
    for sub, o in zip(ins, ops):
        for ch, n in zip(sub, o.shape):
            size[ch] = int(n)
    out_bytes = math.prod(size[c] for c in out) * ops[0].element_size()

    targets = [list(o.placements) for o in ops]
    chosen: list = []
    split = {c: 1 for c in size}  # how many ways each letter is cut
    names = mesh.mesh_dim_names or ()
    for m in range(mesh.ndim):
        g = mesh.size(m)
        bw = (NVLINK_BW if m < len(names) and names[m] in INTRA_HOST_AXES
              else IB_BW)
        held = {sub[p.dim] for sub, o in zip(ins, ops)
                for p in [o.placements[m]] if isinstance(p, Shard)}
        best, best_cost = None, None
        for letter in [None, *sorted(held)]:
            if letter is not None and (size[letter] // split[letter]) % g:
                continue
            moved = 0.0
            for sub, o in zip(ins, ops):
                p = o.placements[m]
                if isinstance(p, Shard) and sub[p.dim] != letter:
                    moved += _local_bytes(o) * (g - 1)  # gather or move
            if letter is not None and letter not in out:
                moved += 2.0 * out_bytes / math.prod(
                    split[c] for c in out) * (g - 1) / g
            flops = 2.0 * math.prod(size[c] / split[c] for c in size)
            if letter is not None:
                flops /= g
            cost = moved / bw + flops / PEAK_FLOPS
            if best_cost is None or cost < best_cost:
                best, best_cost = letter, cost
        chosen.append(best)
        if best is not None:
            split[best] *= g
        for i, sub in enumerate(ins):
            targets[i][m] = (Shard(sub.index(best))
                             if best is not None and best in sub
                             else Replicate())
    ops = [o if list(o.placements) == t else o.redistribute(mesh, t)
           for o, t in zip(ops, targets)]
    local = _EINSUM(eq, *[o.to_local() for o in ops])
    placements = []
    for letter in chosen:
        if letter is None:
            placements.append(Replicate())
        elif letter in out:
            placements.append(Shard(out.index(letter)))
        else:
            placements.append(Partial())
    shape = torch.Size(size[c] for c in out)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


_MATMUL = torch.matmul
_TENSOR_MATMUL = torch.Tensor.__matmul__


def _matmul_eq(a_ndim: int, b_ndim: int) -> str | None:
    """The einsum of ``a @ b`` for ``(..., m, k) @ (k, n)`` and for equal
    batch ranks; ``None`` for other ranks."""
    letters = "abcdefgh"
    if b_ndim == 2 and a_ndim >= 2:
        lead = letters[:a_ndim - 1]
        return f"{lead}k,kn->{lead}n"
    if a_ndim == b_ndim and a_ndim >= 3:
        batch = letters[:a_ndim - 2]
        return f"{batch}mk,{batch}kn->{batch}mn"
    return None


def sharded_matmul(a, b):
    """``a @ b``, planned as :func:`sharded_einsum` when either is a
    DTensor of ranks :func:`_matmul_eq` covers."""
    if _is_dtensor(a) or _is_dtensor(b):
        eq = _matmul_eq(a.dim(), b.dim())
        if eq is not None:
            return sharded_einsum(eq, a, b)
    return _MATMUL(a, b)


@contextlib.contextmanager
def dtensor_einsum():
    """Run the block with :func:`sharded_einsum` as ``torch.einsum`` and
    :func:`sharded_matmul` as ``torch.matmul`` and ``Tensor.__matmul__``."""
    torch.einsum = sharded_einsum
    torch.matmul = sharded_matmul
    torch.Tensor.__matmul__ = sharded_matmul
    try:
        yield
    finally:
        torch.einsum = _EINSUM
        torch.matmul = _MATMUL
        torch.Tensor.__matmul__ = _TENSOR_MATMUL


# ---------------------------------------------------------------------------
# per-shard calls
# ---------------------------------------------------------------------------


def _as_dtensor(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    if t is None or _is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _wrap(local, mesh, placements, letters, sizes):
    """``local`` as a DTensor whose ``letters`` dims are sharded as
    ``placements`` say, its global shape from ``sizes``."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(sizes.get(c, n) if c != "." else n
                       for c, n in zip(letters, local.shape))
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def shard_local(fn, tensors, dims, out_dims, *args, **kwargs):
    """``fn(*tensors, *args, **kwargs)``, run on local shards when some
    tensor is a DTensor.  ``dims[i]`` names each dim of ``tensors[i]`` by
    a letter, ``"."`` for a dim ``fn`` mixes; the same letter is the same
    axis across tensors.  Per mesh dim the first tensor sharded there on a
    lettered dim decides the letter, and every tensor holding it is
    sharded on it (a slice, where it was replicated); every other dim is
    replicated.  A letter may have other sizes in other tensors (GQA's
    key heads); it is sharded only where every size divides, and an
    output's lettered dims take their global size from the first tensor.
    ``out_dims`` letters ``fn``'s output (a tensor or a tuple; ``None``
    entries pass through)."""
    if not any(_is_dtensor(t) for t in tensors):
        return fn(*tensors, *args, **kwargs)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = next(t.device_mesh for t in tensors if _is_dtensor(t))
    ts = [_as_dtensor(t, mesh) for t in tensors]
    sizes, extents = {}, {}  # a letter's size in the first tensor; all
    for t, d in zip(ts, dims):
        if t is not None:
            for c, n in zip(d, t.shape):
                if c != ".":
                    sizes.setdefault(c, int(n))
                    extents.setdefault(c, []).append(int(n))
    chosen = []
    for m in range(mesh.ndim):
        letter = None
        for t, d in zip(ts, dims):
            p = None if t is None else t.placements[m]
            if isinstance(p, Shard) and d[p.dim] != ".":
                letter = d[p.dim]
                break
        if letter is not None and any(n % mesh.size(m)
                                      for n in extents[letter]):
            letter = None
        chosen.append(letter)
    locs = []
    for t, d in zip(ts, dims):
        if t is None:
            locs.append(None)
            continue
        want = [Shard(d.index(c)) if c is not None and c in d
                else Replicate() for c in chosen]
        have = list(t.placements)
        if any(isinstance(p, Partial) for p in have):
            t = t.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                      else p for p in have])
        if list(t.placements) != want:
            t = t.redistribute(mesh, want)
        locs.append(t.to_local())
    out = fn(*locs, *args, **kwargs)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = []
    for o, d in zip(outs, out_dims):
        if o is None:
            wrapped.append(None)
            continue
        pl = [Shard(d.index(c)) if c is not None and c in d else Replicate()
              for c in chosen]
        wrapped.append(_wrap(o, mesh, pl, d, sizes))
    return tuple(wrapped) if isinstance(out, tuple) else wrapped[0]


def per_head(fn, q, k, v, **kwargs):
    """Attention ``fn(q, k, v, **kwargs)`` over ``(b, s, h, d)`` tensors,
    run per shard of the batch and heads (:func:`shard_local`).  GQA keys
    and values are expanded to the query heads first where the queries'
    heads are sharded and theirs are not, so each device holds the key
    heads its query heads read."""
    if not any(_is_dtensor(t) for t in (q, k, v)):
        return fn(q, k, v, **kwargs)
    from torch.distributed.tensor import Shard

    n_rep = q.shape[2] // k.shape[2]
    q_heads = _is_dtensor(q) and any(isinstance(p, Shard) and p.dim == 2
                                     for p in q.placements)
    k_heads = _is_dtensor(k) and any(isinstance(p, Shard) and p.dim == 2
                                     for p in k.placements)
    if n_rep > 1 and q_heads and not k_heads:
        def expand(t):
            b, s, h, d = t.shape
            return t[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
                b, s, h * n_rep, d)

        k, v = expand(k), expand(v)
    return shard_local(fn, (q, k, v), ("b.h.", "b.h.", "b.h."), ("b.h.",),
                       **kwargs)


def take_rows(table, idx):
    """``table[idx]`` (an embedding lookup).  On a DTensor table: the
    table's non-vocab dims are gathered, ``idx`` is replicated over the
    mesh dims that shard the vocab and keeps its shards elsewhere, each
    device gathers the rows its vocab slice holds (zeros for the others),
    and the result is ``Partial`` over the vocab's mesh dims."""
    if not (_is_dtensor(table) or _is_dtensor(idx)):
        return table[idx]
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = (table if _is_dtensor(table) else idx).device_mesh
    table, idx = _as_dtensor(table, mesh), _as_dtensor(idx, mesh)
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    t_want = [Shard(0) if v else Replicate() for v in vocab]
    i_want = [Replicate() if v or not isinstance(p, Shard) else p
              for v, p in zip(vocab, idx.placements)]
    if list(table.placements) != t_want:
        table = table.redistribute(mesh, t_want)
    if list(idx.placements) != i_want:
        idx = idx.redistribute(mesh, i_want)
    rows, ids = table.to_local(), idx.to_local()
    lo, n = 0, rows.shape[0]
    for m, v in enumerate(vocab):  # this device's first vocab row
        if v:
            lo = lo * mesh.size(m) + mesh.get_local_rank(m)
    lo *= n
    own = (ids >= lo) & (ids < lo + n)
    local = rows[torch.where(own, ids - lo, 0)] * own[..., None].to(
        rows.dtype)
    from torch.distributed.tensor import DTensor

    pl = [Partial() if v else p for v, p in zip(vocab, i_want)]
    shape = torch.Size(tuple(idx.shape) + (table.shape[1],))
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())
