"""Whole runs of the harness on the CPU at a tiny size, sound and broken."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cardbench import harness, trace
from cardbench.reference import cnn
from cardbench.tests.tables import resnet18_table

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SIZE = 32  # images of 32 x 32: every layer of both networks still runs


def _cli(*args, cwd=ROOT, timeout=300):
    return subprocess.run(
        [sys.executable, "cardbench/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=timeout,
    )


def test_cpu_dry_run_prints_no_device_metric():
    p = _cli("--workload", "vgg16_f32.bulk", "--seed", "2147483649",
             "--seconds", "0.5", "--trace", "0", "--cpu-dry-run", str(SIZE))
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["dry_run"] and out["correct"] and out["failed"] == 0
    assert out["metrics"] == {} and "device" not in out
    assert list(out)[-1] == "checks"
    assert "check logit_rel_err" in p.stderr.strip().splitlines()[-1]
    split = next(x for x in p.stderr.splitlines() if x.startswith("set-up s"))
    for stage in ("python_start", "torch_import", "harness_import", "weights",
                  "engine_and_warm_up"):
        assert f"'{stage}'" in split


@pytest.mark.skipif("torch.cuda.is_available()")
def test_no_card_no_result():
    p = _cli("--workload", "vgg16_f32.bulk", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli("--workload", "vgg16_f32.bulk", "--seed", "1", "--seconds",
             "0.2", "--cpu-dry-run", str(SIZE), cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def _half_batch(run_network):
    def broken(x, params, **kw):
        logits, skips = run_network(x, params, **kw)
        half = (logits.shape[0] + 1) // 2
        logits = logits.clone()
        logits[half:] = logits[:logits.shape[0] - half]
        return logits, skips
    return broken


def _one_answer_altered(run_network):
    def broken(x, params, **kw):
        logits, skips = run_network(x, params, **kw)
        logits = logits.clone()
        logits[0, 0] += 0.01 * float(logits[0].abs().max())
        return logits, skips
    return broken


# each cell with the faults it can have: half a batch dropped, an answer
# altered where it is produced
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, _half_batch, _one_answer_altered])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    from repro_torch.net import serve

    if fault is not None:
        monkeypatch.setattr(serve, "run_network", fault(serve.run_network))
    out = harness.run_cell(cell, 5, 0.4, False, device="cpu",
                           input_size=SIZE, log=lambda m: None)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("name", ["vgg16_f32", "resnet18_f32"])
def test_reference_matches_the_programs_cpu_path(name):
    from repro_torch.net.partition import auto_partition
    from repro_torch.net.runner import prepare_network_params, run_network

    if name == "resnet18_f32":
        cfg = resnet18_table(SIZE)
    else:
        cfg = dict(harness.find_cell(f"{name}.bulk").cfg, input_size=SIZE)
    params = harness.make_params(cfg, 3, "cpu")
    x = torch.from_numpy(harness.make_pool(cfg, 4, 4, "cpu"))
    graph = harness.port_graph(cfg)
    plan = auto_partition(graph, batch=4)
    ours, _ = run_network(x, prepare_network_params(plan, params), plan=plan)
    ref = cnn.forward(cfg, params, x)
    assert harness.row_errors(ours.numpy(), ref.numpy()).max() < 1e-5


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_fails_the_limit(cell):
    out = harness.run_cell(cell, 8, 0.3, False, device="cpu",
                           input_size=SIZE, control=True, log=lambda m: None)
    limit = out["checks"]["logit_rel_err"]["limit"]
    assert out["correct"]
    assert out["control"] > 3 * limit


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0 - 2**-12])
    y = cnn._tf32(x)
    assert y.tolist() == [1.0, 1.0, 1.0 + 2**-9, -3.0]


class _Ev:
    def __init__(self, name, start, end, device=False, parent=None):
        self.name = name
        self.time_range = type("R", (), {"start": start, "end": end})()
        self.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"
        self.cpu_parent = parent


def test_trace_reduction():
    events = [
        _Ev("cardbench.window", 0, 1000),
        _Ev("cardbench.window", 0, 1000, device=True),
        _Ev("k1", -50, 100, device=True),
        _Ev("k1", 400, 600, device=True),
        _Ev("Memcpy HtoD", 550, 650, device=True),
        _Ev("cardbench.submit", 100, 400),
        _Ev("aten::pin_memory", 700, 990),
    ]
    t = trace.reduce(events)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(350e-6)
    assert t.kernel_s() == pytest.approx(300e-6)  # the copy is no kernel
    assert t.gaps[0] == ["none / aten::pin_memory", pytest.approx(350e-6)]
    assert t.gaps[1] == ["submit / none", pytest.approx(300e-6)]
    assert trace.reduce(events[2:]) is None


def test_readers_on_counted_work():
    cell = harness.find_cell("vgg16_f32.bulk")
    run = harness.Run(
        cell=cell, seconds=2.0, setup_s=3.0,
        latency_s=np.array([0.001] * 19 + [np.inf]),
        completed_in_window=19,
        delta={"buckets": {8: {"batches": 1, "images": 8, "wall_s": 0.02},
                           16: {"batches": 1, "images": 11, "wall_s": 0.03}},
               "launches": {"fused_pyramid": 70}},
        trace=trace.Trace(window_s=2.0, busy_s=0.5,
                          device_s={"void pyramid_kernel<float>": 0.35,
                                    "a renamed conv kernel": 0.05,
                                    "Memcpy HtoD (Pinned -> Device)": 0.1}),
    )
    read = lambda kind, n: harness.load_reader(kind, n)(run)  # noqa: E731
    assert read("end_to_end", "setup_s") == 3.0
    assert read("end_to_end", "images_per_s") == 9.5
    assert read("metrics", "images_per_batch.bulk") == pytest.approx(19 / 2)
    assert read("metrics", "launches_per_image.bulk") == pytest.approx(70 / 19)
    assert read("metrics", "idle_share.bulk") == pytest.approx(75.0)
    assert read("metrics", "forward_mfu.bulk") == pytest.approx(
        100 * 30.94052864e9 * 19 / 2.0 / 67e12)
    # 24 rows launched; every kernel counts, whatever its name
    assert read("metrics", "conv_roofline.bulk") == pytest.approx(
        100 * 24 * 30.693261312e9 / 67e12 / 0.4)
    run.trace = None
    assert read("metrics", "conv_roofline.bulk") is None
    assert read("metrics", "idle_share.bulk") is None
