"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke`` loads neither JAX nor the reference package, and without a
CUDA device the entry points refuse instead of quietly running on the CPU.

Runs in subprocesses so this process's own imports cannot mask a leak.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaks = sorted(m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), "modules;", "leaks:", leaks)
sys.exit(1 if leaks else 0)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env.update(extra)
    return env


def test_no_module_imports_jax_or_the_reference():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "leaks: []" in out.stdout
    assert int(out.stdout.split()[0]) >= 88  # 81 before parallel/ and launch/


def test_only_the_eager_rung_asks_for_the_plain_version():
    """``plain=`` on a kernel wrapper runs the plain version on a CUDA
    tensor.  Only the guarded runner's recorded eager rung may ask for it;
    every other call in the port passes no ``plain`` or forwards its own."""
    import ast

    askers = []
    for path in sorted([*(REPO / "src" / "repro_torch").rglob("*.py"),
                        REPO / "chip_smoke.py"]):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                forwarded = (isinstance(kw.value, ast.Name)
                             and kw.value.id == "plain")
                if kw.arg == "plain" and not forwarded:
                    askers.append(f"{path.relative_to(REPO)}:{node.lineno}")
    assert [a.split(":")[0] for a in askers] == [
        "src/repro_torch/robust/degrade.py"
    ], askers


def test_chip_smoke_refuses_without_cuda():
    """No card: non-zero exit and no result line on stdout."""
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
        env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode != 0
    assert out.stdout == ""


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env(CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_entry_points_need_a_device_without_cuda():
    code = (
        "import torch\n"
        "from repro_torch.core import resolve_device\n"
        "from repro_torch.net.graph import lenet5\n"
        "from repro_torch.net.runner import init_network_params\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models.model import init_params\n"
        "from repro_torch.models.serving import init_caches\n"
        "from repro_torch.launch.serve import serve\n"
        "from repro_torch.obs import explain\n"
        "cfg = get_config('mamba2_780m').reduced()\n"
        "for f in (resolve_device, lambda: init_network_params(lenet5()),\n"
        "          lambda: init_params(cfg), lambda: init_caches(cfg, 1, 4),\n"
        "          lambda: serve('mamba2_780m'),\n"
        "          lambda: explain.main(['--model', 'lenet', '--run']),\n"
        "          lambda: explain.main(['--model', 'lenet', '--guard'])):\n"
        "    try:\n"
        "        f()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e)\n"
        "    else:\n"
        "        raise SystemExit('fell back to the CPU')\n"
        "print(resolve_device('cpu'))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO,
        env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "cpu"
