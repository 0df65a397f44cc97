"""The benchmark's files: found by name, free of JAX, counted right."""

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest

from cardbench import counts, harness
from cardbench.tests.tables import resnet18_table
from cardbench.traffic.generator import ClosedRequests

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cardbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [
        c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.find_cell(cell)
    assert c.workload["buckets"] == sorted(set(c.workload["buckets"]))
    assert c.traffic["loop"] == "closed"
    assert 0 < c.workload["logit_rel_err_limit"] < 1
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end:
        assert callable(harness.load_reader("end_to_end", m["name"]))
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.load_reader("metrics", m["name"]))


def test_every_metric_has_cells_that_report_its_end_to_end_metric():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            c = harness.find_cell(cell)
            assert m["moves"] in {e["name"] for e in c.end_to_end}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize(
    "path", sorted((ROOT / "cardbench").rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_imports(path):
    found = _imports(path)
    assert not found & {"jax", "jaxlib", "flax", "repro", "benchmarks",
                        "chip_smoke"}
    if "reference" in path.parts:
        assert "repro_torch" not in found
    if "tests" not in path.parts:  # nothing reads the JAX package's files
        assert "BENCH_pyramid" not in path.read_text()


def _cfg(name: str) -> dict:
    """A committed configuration by name, or ResNet-18's table, which the
    reference and the counts also walk (``tables.py``)."""
    if name == "resnet18_f32":
        return resnet18_table()
    conf = {c["name"]: c for c in BENCH["configs"]}[name]
    return json.loads((ROOT / conf["file"]).read_text())


@pytest.mark.parametrize(
    "name", [c["name"] for c in BENCH["configs"]] + ["resnet18_f32"])
def test_flop_count_equals_the_programs_shapes(name):
    from repro_torch.net.graph import MODELS, infer_shapes

    cfg = _cfg(name)
    graph = MODELS[cfg["port_model"]]()
    shapes = infer_shapes(graph)
    macs = 0
    for n in graph.nodes:
        src = shapes[n.inputs[0]] if n.inputs else None
        if n.op == "conv":
            macs += shapes[n.name].size ** 2 * n.K ** 2 * src.channels * n.n_out
        elif n.op == "dense":
            macs += src.channels * n.n_out
    assert counts.flops_per_image(cfg) == 2 * macs
    harness.port_graph(cfg)  # the layer tables agree node by node
    expect = {"vgg16_f32": 30.94e9, "resnet18_f32": 3.628e9}[name]
    assert abs(counts.flops_per_image(cfg) / expect - 1) < 1e-3


def test_closed_requests_follow_the_mix_and_stay_in_the_pool():
    traffic = {"loop": "closed", "clients": 3, "rows": {"1": 0.5, "8": 0.5},
               "pool_images": 16}
    gen = ClosedRequests(traffic, np.random.default_rng(2**40 + 3))
    drawn = [gen.next() for _ in range(4000)]
    assert gen.clients == 3
    assert {r for r, _ in drawn} == {1, 8}
    assert abs(sum(r == 8 for r, _ in drawn) / 4000 - 0.5) < 0.05
    assert all(0 <= s and s + r <= 16 for r, s in drawn)
    with pytest.raises(ValueError):
        ClosedRequests(dict(traffic, loop="open"), np.random.default_rng(1))
