"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_no_jax_or_reference_imports_in_the_port():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [
        f"{f.relative_to(ROOT)}: {name}"
        for f in files
        for name in _imported_modules(f)
        if _foreign(name)
    ]
    assert not bad, bad


def test_importing_the_port_leaves_jax_unloaded():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch.')]))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.engine import make_engine
    from repro_torch.kernels.ref import BucketSpec
    from repro_torch.telemetry.keyed import KeyedWindow

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = BucketSpec(num_buckets=512, offset=-256)
    with pytest.raises(RuntimeError, match="cuda"):
        KeyedWindow(spec, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        make_engine(spec, 4)
    assert KeyedWindow(spec, 4, device="cpu").bank.pos.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: chip_smoke.py would run for real")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True, text=True,
        timeout=120, cwd=tmp_path,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
