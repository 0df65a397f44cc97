"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke`` loads neither JAX nor the reference package, and without a
CUDA device the entry points refuse instead of quietly running on the CPU.

Runs in subprocesses so this process's own imports cannot mask a leak.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted((REPO / "examples").glob("torch_*.py"))

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


def test_four_examples_exist():
    assert [p.name for p in EXAMPLES] == [
        "torch_fused_cnn_inference.py", "torch_quickstart.py",
        "torch_serve_lm.py", "torch_train_lm.py",
    ]


@pytest.mark.parametrize("example", EXAMPLES, ids=lambda p: p.stem)
def test_example_imports_neither_jax_nor_the_reference(example):
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('ex', {str(example)!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "leaks = sorted(m for m in sys.modules\n"
        "               if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('leaks:', leaks)\n"
        "sys.exit(1 if leaks else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "leaks: []" in out.stdout


@pytest.mark.parametrize("example", EXAMPLES, ids=lambda p: p.stem)
def test_example_refuses_without_cuda(example):
    """Run as a script with no card: non-zero exit, nothing on stdout, and
    the reason on stderr."""
    out = subprocess.run(
        [sys.executable, str(example)], cwd=REPO,
        env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def _all_names(path: pathlib.Path) -> list[str]:
    """A module's ``__all__`` list, read from its source."""
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__"
                        for t in node.targets)):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


def test_core_exports_the_reference_api():
    """``repro_torch.core.__all__`` holds the counterpart of every name in
    ``repro.core.__all__``, ``resolve_device`` standing for
    ``resolve_interpret``, and each name resolves."""
    ref = _all_names(REPO / "src" / "repro" / "core" / "__init__.py")
    ours = _all_names(REPO / "src" / "repro_torch" / "core" / "__init__.py")
    want = {"resolve_device" if n == "resolve_interpret" else n for n in ref}
    assert len(ref) == 33
    assert want == set(ours)
    code = (
        "import repro_torch.core as c\n"
        "missing = [n for n in c.__all__ if not hasattr(c, n)]\n"
        "print('missing:', missing)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "missing: []" in out.stdout


@pytest.mark.parametrize("first", [
    "import repro_torch.core",
    "from repro_torch.core import plan_fusion, fused_forward, evaluate_design,"
    " end_statistics, to_digits",
    "import repro_torch.core.executor",
    "import repro_torch.core.cnn_models",
    "import repro_torch.net.runner",
    "from repro_torch.core.cnn_models import LENET5_LEVELS, ALEXNET_LEVELS,"
    " VGG_BLOCK12_LEVELS",
])
def test_core_imports_without_a_cycle(first):
    """The package's first import, from a fresh process, by any door."""
    out = subprocess.run(
        [sys.executable, "-c", first], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
