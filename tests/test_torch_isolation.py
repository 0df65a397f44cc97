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
    assert int(out.stdout.split()[0]) >= 15  # the slice's modules


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
        "for f in (resolve_device, lambda: init_network_params(lenet5())):\n"
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
