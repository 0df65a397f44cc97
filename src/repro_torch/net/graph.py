"""CNN graph IR: whole networks as explicit dataflow graphs.

A copy of the reference package's ``repro.net.graph`` (pure Python, so
every model both zoos have, and every segment it yields, is identical in
both packages), plus :func:`resnet50`, which only this package has.

A :class:`Graph` is a topologically-ordered tuple of :class:`Node` — conv /
pool / relu / residual-add / global-pool / flatten / dense — each naming its
producer nodes.  Construction validates the whole graph (unique names,
forward references only, shape/channel chaining) so malformed networks fail
here with a named node, not deep inside a kernel.

The IR is the single source of the model zoo: :func:`lenet5`,
:func:`alexnet`, :func:`vgg16`, :func:`resnet18` and :func:`resnet50`
(port-only).  All builders take
``input_size`` so tests and CPU runs can use reduced-scale variants of the
same topology.

:func:`fusable_segments` extracts the maximal linear conv/pool chains the
auto-partitioner (:mod:`repro_torch.net.partition`) is allowed to cut into fusion
pyramids.  Chain boundaries — residual joins, multi-consumer forks (the
block input feeding both body and shortcut), standalone activations, the
classifier head — are exactly the IR nodes that force a feature map to
materialize, i.e. the partitioner's legal cut points.

Activation convention: conv and dense nodes carry a fused ``relu`` flag (the
paper's pyramids are conv+ReLU stacks; the pyramid kernel applies ReLU per
conv level), while standalone ``relu`` nodes express post-residual-add
activations.  A fusable chain must be relu-uniform across its convs because
one pyramid launch applies a single activation mode.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.dtypes import canonical_dtype, dtype_bytes
from repro_torch.core.fusion import FusedLevel, FusionSpec

_OPS = ("input", "conv", "pool", "relu", "add", "global_pool", "flatten", "dense")


@dataclass(frozen=True)
class Node:
    """One IR node.  ``K``/``S``/``pad`` apply to conv and pool nodes,
    ``n_out`` to conv and dense nodes, ``relu`` to conv and dense nodes
    (fused activation)."""

    op: str
    name: str
    inputs: tuple[str, ...] = ()
    K: int = 0
    S: int = 1
    pad: int = 0
    n_out: int = 0
    relu: bool = True


@dataclass(frozen=True)
class Shape:
    """Feature shape leaving a node: a square ``size x size x channels`` map,
    or a flat vector (``size == 0``, ``channels`` = feature count)."""

    size: int
    channels: int

    @property
    def is_map(self) -> bool:
        return self.size > 0


@dataclass(frozen=True)
class Graph:
    """A whole CNN as a topologically-ordered node tuple.

    ``nodes[0]`` must be the single ``input`` node; ``nodes[-1]`` is the
    network output (the logits for the zoo models).  Hashable — the
    partition cache keys on it.

    ``compute_dtype`` (canonical name string, DESIGN.md §11) is the value
    width the network's tiles and weights move at — the default the
    partitioner and runner inherit when no explicit dtype override is given.
    Accumulation is always f32 regardless.
    """

    name: str
    input_size: int
    in_channels: int
    nodes: tuple[Node, ...]
    compute_dtype: str = "float32"

    def __post_init__(self) -> None:
        if not self.nodes or self.nodes[0].op != "input":
            raise ValueError(f"graph {self.name}: nodes[0] must be the input node")
        object.__setattr__(
            self, "compute_dtype", canonical_dtype(self.compute_dtype)
        )
        infer_shapes(self)  # raises on any structural error

    def node(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(f"graph {self.name} has no node {name!r}")

    @property
    def output(self) -> Node:
        return self.nodes[-1]

    def consumers(self) -> dict[str, tuple[str, ...]]:
        out: dict[str, tuple[str, ...]] = {n.name: () for n in self.nodes}
        for n in self.nodes:
            for src in n.inputs:
                out[src] = out[src] + (n.name,)
        return out


def infer_shapes(graph: Graph) -> dict[str, Shape]:
    """Shape/channel inference over the whole graph; the single validation
    pass every other net/ component builds on.  Raises ``ValueError`` naming
    the offending node."""
    shapes: dict[str, Shape] = {}
    for n in graph.nodes:
        if n.op not in _OPS:
            raise ValueError(f"node {n.name}: unknown op {n.op!r}")
        if n.name in shapes:
            raise ValueError(f"node {n.name}: duplicate name")
        ins = []
        for src in n.inputs:
            if src not in shapes:
                raise ValueError(
                    f"node {n.name}: input {src!r} is not an earlier node"
                )
            ins.append(shapes[src])
        n_in = {"input": 0, "add": 2}.get(n.op, 1)
        if len(ins) != n_in:
            raise ValueError(
                f"node {n.name}: op {n.op} takes {n_in} inputs, got {len(ins)}"
            )
        if n.op == "input":
            shapes[n.name] = Shape(graph.input_size, graph.in_channels)
            continue
        if n.op in ("conv", "pool"):
            s = ins[0]
            if not s.is_map:
                raise ValueError(f"node {n.name}: {n.op} needs a feature map")
            out = (s.size + 2 * n.pad - n.K) // n.S + 1
            if out < 1:
                raise ValueError(
                    f"node {n.name}: K={n.K} S={n.S} pad={n.pad} leaves no "
                    f"output from a {s.size}x{s.size} input"
                )
            ch = n.n_out if n.op == "conv" else s.channels
            shapes[n.name] = Shape(out, ch)
        elif n.op == "relu":
            shapes[n.name] = ins[0]
        elif n.op == "add":
            if ins[0] != ins[1]:
                raise ValueError(
                    f"node {n.name}: add operands disagree: {ins[0]} vs {ins[1]}"
                )
            shapes[n.name] = ins[0]
        elif n.op == "global_pool":
            if not ins[0].is_map:
                raise ValueError(f"node {n.name}: global_pool needs a feature map")
            shapes[n.name] = Shape(0, ins[0].channels)
        elif n.op == "flatten":
            s = ins[0]
            feats = s.size * s.size * s.channels if s.is_map else s.channels
            shapes[n.name] = Shape(0, feats)
        elif n.op == "dense":
            if ins[0].is_map:
                raise ValueError(
                    f"node {n.name}: dense needs a flat vector (flatten or "
                    "global_pool first)"
                )
            shapes[n.name] = Shape(0, n.n_out)
    return shapes


# ---------------------------------------------------------------------------
# Fusable segments — the partitioner's search domains
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Segment:
    """A maximal linear conv/pool chain: the domain one dynamic program cuts.

    Every interior node has exactly one consumer (its successor), so no map
    inside the segment is needed elsewhere — fusing across any interior edge
    is legal.  Segment ends are the graph's materialization points.
    """

    nodes: tuple[Node, ...]
    input_size: int
    in_channels: int
    relu: bool  # uniform fused activation of the chain's convs

    @property
    def node_names(self) -> tuple[str, ...]:
        return tuple(n.name for n in self.nodes)

    def spec(self) -> FusionSpec:
        """Lower the chain to the fusion planner's :class:`FusionSpec`."""
        return FusionSpec(
            levels=_levels(self.nodes, self.in_channels),
            input_size=self.input_size,
        )


def _levels(nodes: tuple[Node, ...], in_channels: int) -> tuple[FusedLevel, ...]:
    levels, c = [], in_channels
    for n in nodes:
        if n.op == "conv":
            levels.append(
                FusedLevel("conv", K=n.K, S=n.S, pad=n.pad, n_in=c,
                           n_out=n.n_out, name=n.name)
            )
            c = n.n_out
        else:
            levels.append(
                FusedLevel("pool", K=n.K, S=n.S, pad=n.pad, n_in=c, n_out=c,
                           name=n.name)
            )
    return tuple(levels)


def fusable_segments(graph: Graph) -> tuple[Segment, ...]:
    """Maximal fusable chains, in topological order.

    A conv starts or extends a chain; a pool extends one.  A node extends the
    current chain only when it consumes the chain tail, the tail has no other
    consumer, and (for convs) its fused-relu mode matches the chain's — a
    pyramid launch applies one activation mode.  Everything else (residual
    add, fork, head op) terminates the chain: these are the cut points.
    """
    shapes = infer_shapes(graph)
    n_consumers = {k: len(v) for k, v in graph.consumers().items()}
    segments: list[Segment] = []
    cur: list[Node] = []

    def flush() -> None:
        if cur:
            src = graph.node(cur[0].inputs[0])
            s_in = shapes[src.name]
            segments.append(
                Segment(
                    nodes=tuple(cur),
                    input_size=s_in.size,
                    in_channels=s_in.channels,
                    relu=cur[0].relu,
                )
            )
            cur.clear()

    for n in graph.nodes:
        if n.op in ("conv", "pool"):
            extends = (
                cur
                and n.inputs[0] == cur[-1].name
                and n_consumers[cur[-1].name] == 1
                and (n.op == "pool" or n.relu == cur[0].relu)
            )
            if extends:
                cur.append(n)
                continue
            flush()
            if n.op == "conv":
                cur.append(n)
            # an orphan pool (no conv head) cannot start a pyramid; the
            # runner executes it as a plain op
        else:
            flush()
    flush()
    return tuple(segments)


def residual_joins(graph: Graph) -> tuple[tuple[str, str | None], ...]:
    """Each residual ``add`` node with the ``relu`` node that is its only
    consumer (``None`` when it has none), in graph order: the joins a
    forward runs as plain ops between its pyramid launches."""
    consumers = graph.consumers()
    joins = []
    for n in graph.nodes:
        if n.op != "add":
            continue
        after = consumers[n.name]
        relu = (after[0] if len(after) == 1
                and graph.node(after[0]).op == "relu" else None)
        joins.append((n.name, relu))
    return tuple(joins)


def join_bytes(graph: Graph, add: str, relu: str | None, batch: int,
               dtype: str) -> int:
    """Bytes the join at ``add`` moves for ``batch`` images at ``dtype``:
    the add reads two maps and writes one; its ``relu``, when it has one,
    reads and writes one more."""
    shape = infer_shapes(graph)[add]
    elements = batch * shape.size * shape.size * shape.channels
    return elements * dtype_bytes(dtype) * (3 if relu is None else 5)


# ---------------------------------------------------------------------------
# Model zoo
# ---------------------------------------------------------------------------


class _Builder:
    """Tiny fluent helper: tracks the running tail so linear stretches read
    like layer lists; returns node names for explicit wiring."""

    def __init__(self, in_name: str = "image"):
        self.nodes: list[Node] = [Node("input", in_name)]
        self.tail = in_name

    def _add(self, node: Node) -> str:
        self.nodes.append(node)
        self.tail = node.name
        return node.name

    def conv(self, name, K, S, pad, n_out, *, src=None, relu=True) -> str:
        return self._add(
            Node("conv", name, (src or self.tail,), K=K, S=S, pad=pad,
                 n_out=n_out, relu=relu)
        )

    def pool(self, name, K, S, pad=0, *, src=None) -> str:
        return self._add(Node("pool", name, (src or self.tail,), K=K, S=S, pad=pad))

    def op(self, op, name, *srcs, n_out=0, relu=True) -> str:
        return self._add(
            Node(op, name, srcs or (self.tail,), n_out=n_out, relu=relu)
        )

    def graph(self, name, input_size, in_channels,
              compute_dtype="float32") -> Graph:
        return Graph(name, input_size, in_channels, tuple(self.nodes),
                     compute_dtype)


def lenet5(input_size: int = 32, num_classes: int = 10, *,
           compute_dtype: str = "float32") -> Graph:
    """LeNet-5 (paper §3.3.1): two conv+pool stages, three dense layers."""
    b = _Builder()
    b.conv("CL1", 5, 1, 0, 6)
    b.pool("MPL1", 2, 2)
    b.conv("CL2", 5, 1, 0, 16)
    b.pool("MPL2", 2, 2)
    b.op("flatten", "flatten")
    b.op("dense", "FC1", n_out=120)
    b.op("dense", "FC2", n_out=84)
    b.op("dense", "FC3", n_out=num_classes, relu=False)
    return b.graph("lenet", input_size, 1, compute_dtype)


def alexnet(input_size: int = 227, num_classes: int = 1000, *,
            compute_dtype: str = "float32") -> Graph:
    """AlexNet conv stack (no LRN) + the three dense layers."""
    b = _Builder()
    b.conv("CONV1", 11, 4, 0, 96)
    b.pool("POOL1", 3, 2)
    b.conv("CONV2", 5, 1, 2, 256)
    b.pool("POOL2", 3, 2)
    b.conv("CONV3", 3, 1, 1, 384)
    b.conv("CONV4", 3, 1, 1, 384)
    b.conv("CONV5", 3, 1, 1, 256)
    b.pool("POOL5", 3, 2)
    b.op("flatten", "flatten")
    b.op("dense", "FC6", n_out=4096)
    b.op("dense", "FC7", n_out=4096)
    b.op("dense", "FC8", n_out=num_classes, relu=False)
    return b.graph("alexnet", input_size, 3, compute_dtype)


_VGG16_PLAN = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def vgg16(input_size: int = 224, num_classes: int = 1000, *,
          compute_dtype: str = "float32") -> Graph:
    """VGG-16: five conv blocks with trailing 2x2 pools, three dense layers."""
    b = _Builder()
    ci = 0
    for bi, (n_convs, ch) in enumerate(_VGG16_PLAN):
        for _ in range(n_convs):
            ci += 1
            b.conv(f"CONV{ci}", 3, 1, 1, ch)
        b.pool(f"POOL{bi + 1}", 2, 2)
    b.op("flatten", "flatten")
    b.op("dense", "FC1", n_out=4096)
    b.op("dense", "FC2", n_out=4096)
    b.op("dense", "FC3", n_out=num_classes, relu=False)
    return b.graph("vgg16", input_size, 3, compute_dtype)


# (n_out, stride of convA) per residual block
_RESNET18_PLAN = ((64, 1), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                  (512, 2), (512, 1))


def resnet18(input_size: int = 224, num_classes: int = 1000, *,
             compute_dtype: str = "float32") -> Graph:
    """ResNet-18: 7x7/2 stem + 3x3/2 maxpool, eight 2-conv residual blocks
    (1x1 projection shortcuts at the stride-2 / channel-change blocks),
    global average pool and the classifier.

    Per the repro's block variant (and the repo's historical per-block
    fusion), every conv applies fused ReLU — including convB before the add —
    since a fusion pyramid applies one activation mode; the residual join is
    a standalone ``add`` + ``relu`` pair.  Projection shortcuts are
    relu-free 1x1 convs, which makes them their own Q=1 pyramids.
    """
    b = _Builder()
    b.conv("conv1", 7, 2, 3, 64)
    b.pool("maxpool", 3, 2, pad=1)
    c_in = 64
    for i, (ch, s1) in enumerate(_RESNET18_PLAN):
        blk, block_in = f"b{i}", b.tail
        b.conv(f"{blk}_convA", 3, s1, 1, ch, src=block_in)
        body = b.conv(f"{blk}_convB", 3, 1, 1, ch)
        if s1 != 1 or c_in != ch:
            shortcut = b.conv(f"{blk}_proj", 1, s1, 0, ch, src=block_in,
                              relu=False)
        else:
            shortcut = block_in
        b.op("add", f"{blk}_add", body, shortcut)
        b.op("relu", f"{blk}_relu")
        c_in = ch
    b.op("global_pool", "gap")
    b.op("dense", "FC", n_out=num_classes, relu=False)
    return b.graph("resnet18", input_size, 3, compute_dtype)


# (bottleneck blocks, width, stride of the stage's first block) per stage;
# each block's output has 4 x its width
_RESNET50_PLAN = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))
_BOTTLENECK_EXPANSION = 4


def resnet50(input_size: int = 224, num_classes: int = 1000, *,
             compute_dtype: str = "float32") -> Graph:
    """ResNet-50 v1.5 (He et al., arXiv:1512.03385, Table 1, 50-layer; the
    stride on the 3x3 conv, as torchvision's ``resnet50`` and MLPerf
    Inference's ResNet-50 v1.5): 7x7/2 stem + 3x3/2 maxpool, sixteen
    bottleneck blocks ``b0``..``b15`` in stages of (3, 4, 6, 3), global
    average pool and the classifier.

    Each block is ``c1`` 1x1 with ReLU, ``c2`` 3x3 (stride 2 on the first
    block of stages 2-4) with ReLU, ``c3`` 1x1 to 4x the width without
    activation, and on the first block of each stage a linear 1x1
    projection ``proj`` with ``c2``'s stride; the join is a standalone
    ``add`` + ``relu`` pair.  Since one pyramid launch applies one
    activation mode, ``c1..c2`` is the fusable chain and ``c3`` and
    ``proj`` launch alone, linear.

    Departure from the published network: batch norm is folded into each
    conv's weight and bias, as inference deployments do.  The model
    exists only in this package, not in the reference's zoo.
    """
    b = _Builder()
    b.conv("conv1", 7, 2, 3, 64)
    b.pool("maxpool", 3, 2, pad=1)
    blk = 0
    for n_blocks, width, stride in _RESNET50_PLAN:
        for i in range(n_blocks):
            name, block_in = f"b{blk}", b.tail
            blk += 1
            s = stride if i == 0 else 1
            out = _BOTTLENECK_EXPANSION * width
            b.conv(f"{name}_c1", 1, 1, 0, width)
            b.conv(f"{name}_c2", 3, s, 1, width)
            body = b.conv(f"{name}_c3", 1, 1, 0, out, relu=False)
            shortcut = block_in
            if i == 0:
                shortcut = b.conv(f"{name}_proj", 1, s, 0, out, src=block_in,
                                  relu=False)
            b.op("add", f"{name}_add", body, shortcut)
            b.op("relu", f"{name}_relu")
    b.op("global_pool", "gap")
    b.op("dense", "FC", n_out=num_classes, relu=False)
    return b.graph("resnet50", input_size, 3, compute_dtype)


MODELS = {
    "lenet": lenet5,
    "alexnet": alexnet,
    "vgg16": vgg16,
    "resnet18": resnet18,
    "resnet50": resnet50,
}


def backbone_prefix(graph: Graph, n_convs: int) -> FusionSpec:
    """FusionSpec of the first ``n_convs`` convs (+ interleaved/trailing
    pools) of the graph's leading fusable segment — how
    :mod:`repro_torch.core.cnn_models` derives the paper's hand-picked fusion
    groups from the zoo graphs."""
    seg = fusable_segments(graph)[0]
    taken, convs = [], 0
    for n in seg.nodes:
        if n.op == "conv":
            if convs == n_convs:
                break
            convs += 1
        taken.append(n)
    if convs < n_convs:
        raise ValueError(
            f"graph {graph.name}: leading segment has only {convs} convs"
        )
    sub = replace(seg, nodes=tuple(taken))
    return sub.spec()
