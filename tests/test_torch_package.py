"""The port's package boundary: ``src/repro_torch`` and ``chip_smoke.py``
import neither ``jax`` nor anything of ``repro``, and importing the port
loads no JAX and builds no kernel."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [
        f"{path.relative_to(REPO)}:{line}: {mod}"
        for line, mod in _imported_modules(path)
        if mod.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert bad == []


def test_import_loads_no_jax_and_builds_nothing():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.api, repro_torch.convert\n"
        "import repro_torch.kernels.topk_compress.ops\n"
        "import repro_torch.kernels.int8_quant.ops\n"
        "import repro_torch.kernels.decode_attention.ops\n"
        "import repro_torch.kernels.pdist_argmin.ops\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.ml, repro_torch.core.admm\n"
        "import repro_torch.serve, repro_torch.models, repro_torch.configs\n"
        "import repro_torch.launch.serve\n"
        "from repro_torch.kernels import build\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))"
        " or m == 'repro' for m in sys.modules), sorted(sys.modules)\n"
        "assert build._LIBS == {}\n"
        "print('OK')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "OK"
