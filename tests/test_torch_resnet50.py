"""ResNet-50 v1.5 in the port's zoo and in the benchmark, on the CPU.

The graph at its published widths (v1.5 strides, linear ``c3`` and
projections, the folded weight count and the FLOPs), the benchmark's
configuration file against the graph layer for layer, ``run_network``
against the benchmark's plain reference and the port's
``reference_network``, the card's batch-32 plan, a whole run of the cell
at 32 x 32 (correct, and not correct with one answer altered), and the
``fused_conv_share.bulk`` reader.  The model exists only in the port, so
there is no JAX reference to hold it against.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cardbench import counts, harness
from cardbench.reference import cnn
from cardbench.tests.tables import table_from_graph
from repro_torch.net.graph import MODELS, fusable_segments, infer_shapes
from repro_torch.net.partition import auto_partition
from repro_torch.net.runner import (
    prepare_network_params,
    reference_network,
    run_network,
)

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "cardbench/configs/resnet50_f32.json").read_text())
CELL = "resnet50_f32.bulk"
# the blocks whose c1..c2 the card fuses at batch 32
FUSED_AT_32 = (4, 5, 6, 8, 9, 10, 11, 12, 14, 15)


def _cfg(input_size: int, classes: int) -> dict:
    cfg = json.loads(json.dumps(CFG))
    cfg["input_size"] = input_size
    cfg["num_classes"] = classes
    cfg["layers"][-1]["out"] = classes
    return cfg


def test_graph_has_the_published_shape():
    g = MODELS["resnet50"]()
    shapes = infer_shapes(g)
    convs = [n for n in g.nodes if n.op == "conv"]
    assert len(convs) == 53
    assert sum(n.op == "add" for n in g.nodes) == 16
    assert sum(n.op == "relu" for n in g.nodes) == 16
    strided = {n.name for n in convs if n.S == 2}
    # v1.5: the stride sits on the 3x3 conv (and its projection)
    assert strided == {"conv1", "b3_c2", "b3_proj", "b7_c2", "b7_proj",
                       "b13_c2", "b13_proj"}
    assert all(not n.relu for n in convs
               if n.name.endswith(("_c3", "_proj")))
    assert all(n.relu for n in convs
               if n.name.endswith(("_c1", "_c2")) or n.name == "conv1")
    assert [n.name for n in convs if n.name.endswith("_proj")] == [
        "b0_proj", "b3_proj", "b7_proj", "b13_proj"]
    assert shapes["b15_relu"].size == 7 and shapes["b15_relu"].channels == 2048
    assert [shapes[f"b{i}_relu"].channels for i in (2, 6, 12, 15)] == [
        256, 512, 1024, 2048]
    weights = 0
    for n in g.nodes:
        if n.op in ("conv", "dense"):
            c_in = shapes[n.inputs[0]].channels
            weights += n.K ** 2 * c_in * n.n_out if n.op == "conv" \
                else c_in * n.n_out
            weights += n.n_out
    assert weights == 25_530_472
    assert counts.flops_per_image(CFG) == 8_178_368_512
    # each block's c1..c2 is the one chain a launch may fuse
    chains = [s.node_names for s in fusable_segments(g) if len(s.nodes) > 1]
    assert chains[0] == ("conv1", "maxpool")
    assert chains[1:] == [(f"b{i}_c1", f"b{i}_c2") for i in range(16)]


def test_config_file_equals_the_graph():
    assert CFG["layers"] == table_from_graph("resnet50", "resnet50_f32")[
        "layers"]
    graph = harness.port_graph(CFG)
    assert graph.name == "resnet50" and graph.compute_dtype == "float32"
    leaves = cnn.weight_leaves(CFG)
    assert sum(np.prod(s) + s[-1] for _, s, _ in leaves) == 25_530_472


@pytest.mark.parametrize("size", [32, 64])
def test_run_network_matches_both_references(size):
    cfg = _cfg(size, 10)
    graph = harness.port_graph(cfg)
    params = harness.make_params(cfg, 2**33 + size, "cpu")
    x = torch.from_numpy(harness.make_pool(cfg, 2, 7, "cpu"))
    plan = auto_partition(graph, batch=2)
    logits, skips = run_network(x, prepare_network_params(plan, params),
                                plan=plan)
    assert logits.shape == (2, 10) and len(skips) == plan.n_launches()
    plain = cnn.forward(cfg, params, x)
    ours = reference_network(x, graph, params)
    # without batch norm the untrained logits reach several hundred, where
    # float32's spacing is 3e-5; the f32 contract scales with them, as on
    # the card (tests/test_torch_cuda.py)
    atol = 1e-4 * max(1.0, float(plain.abs().max()))
    torch.testing.assert_close(logits, plain, atol=atol, rtol=0)
    torch.testing.assert_close(logits, ours, atol=atol, rtol=0)


def test_card_plan_at_batch_32_covers_each_conv_once_and_fuses():
    graph = MODELS["resnet50"]()
    plan = auto_partition(graph, batch=32)
    convs = [n.name for n in graph.nodes if n.op == "conv"]
    covered = [m for p in plan.pyramids for m in p.node_names
               if graph.node(m).op == "conv"]
    assert sorted(covered) == sorted(convs)
    fused = [p.name for p in plan.pyramids if p.q_convs >= 2]
    assert fused == [f"b{i}_c1..b{i}_c2" for i in FUSED_AT_32]
    assert plan.n_launches() == 43
    assert plan.fused_convs() == 20 and plan.joins() == 16


def _one_answer_altered(run_network):
    def broken(x, params, **kw):
        logits, skips = run_network(x, params, **kw)
        logits = logits.clone()
        logits[0, 0] += 0.01 * float(logits[0].abs().max())
        return logits, skips
    return broken


@pytest.mark.parametrize("altered", [False, True])
def test_the_cell_runs_on_the_cpu(monkeypatch, altered):
    from repro_torch.net import serve

    if altered:
        monkeypatch.setattr(serve, "run_network",
                            _one_answer_altered(serve.run_network))
    out = harness.run_cell(CELL, 2**32 + 5, 0.4, False, device="cpu",
                           input_size=32, log=lambda m: None)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"] is not altered, out["checks"]


def _run(buckets: dict, cfg=CFG):
    delta = {"buckets": {b: {"batches": n, "images": n * b, "wall_s": 1.0}
                         for b, n in buckets.items()},
             "launches": {}}
    return SimpleNamespace(cell=SimpleNamespace(cfg=cfg), delta=delta)


def test_fused_conv_share_reader():
    read = harness.load_reader("metrics", "fused_conv_share.bulk")
    graph = MODELS["resnet50"]()
    shapes = infer_shapes(graph)
    flops = {}
    for n in graph.nodes:
        if n.op == "conv":
            flops[n.name] = (2 * shapes[n.name].size ** 2 * n.K ** 2
                             * shapes[n.inputs[0]].channels * n.n_out)
    every = sum(flops.values())
    at = {}
    for bucket in (8, 32):
        plan = auto_partition(graph, batch=bucket)
        at[bucket] = sum(flops[m] for p in plan.pyramids if p.q_convs >= 2
                         for m in p.node_names if m in flops)
    assert read(_run({32: 10})) == pytest.approx(100 * at[32] / every)
    assert read(_run({32: 10})) == pytest.approx(40.8564, abs=1e-3)
    mixed = read(_run({8: 3, 32: 5}))
    want = 100 * (3 * 8 * at[8] + 5 * 32 * at[32]) / ((3 * 8 + 5 * 32) * every)
    assert mixed == pytest.approx(want)
    assert read(_run({})) is None
    # a configuration the program cannot plan reads nothing
    assert read(_run({32: 1}, cfg=dict(CFG, port_model="nope"))) is None
    # VGG-16's batch-32 plan runs one conv a launch
    vgg = harness.find_cell("vgg16_f32.bulk").cfg
    assert read(_run({32: 4}, cfg=vgg)) == 0.0
