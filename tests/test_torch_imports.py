"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or ``repro``, and the package imports in
a process where JAX cannot be imported."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_imports():
    files = _port_files()
    assert {PORT / "core" / "interpreter.py",
            PORT / "runtime" / "executor.py",
            PORT / "models" / "partitioning.py",
            PORT / "models" / "tpcomm.py"} <= set(files)
    bad = [(str(f.relative_to(REPO)), root) for f in files
           for root in _imported_roots(f)
           if root in ("jax", "jaxlib", "repro", "flax", "optax")]
    assert bad == []


def test_imports_without_jax():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    assert {"repro_torch.algorithms.async_rounds",
            "repro_torch.checkpoint.manager", "repro_torch.data.synthetic",
            "repro_torch.optim.schedules", "repro_torch.core.interpreter",
            "repro_torch.runtime.executor",
            "repro_torch.runtime.failure", "repro_torch.runtime.elastic",
            "repro_torch.analysis.findings",
            "repro_torch.analysis.placement_safety",
            "repro_torch.analysis.donation", "repro_torch.analysis.retrace",
            "repro_torch.analysis.commcost",
            "repro_torch.analysis.lints", "repro_torch.algorithms.pipeline",
            "repro_torch.algorithms.maml",
            "repro_torch.algorithms.btm", "repro_torch.launch.steps",
            "repro_torch.launch.serve", "repro_torch.launch.mesh",
            "repro_torch.core.sharding", "repro_torch.models.partitioning",
            "repro_torch.models.tpcomm",
            "repro_torch.configs.stablelm_3b"} <= set(modules)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        "import repro_torch\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert all(not k.startswith(('jax', 'repro.')) for k in sys.modules "
        "if sys.modules[k] is not None)\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_without_card_or_sources(tmp_path):
    """Alone in a directory, or on a machine without a card, the smoke
    exits non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
