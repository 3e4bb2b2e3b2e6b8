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
        "import repro_torch.ml, repro_torch.core, repro_torch.utils\n"
        "import repro_torch.kernels.topk_compress, repro_torch.kernels.int8_quant\n"
        "import repro_torch.kernels.decode_attention, repro_torch.kernels.pdist_argmin\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.serve, repro_torch.models, repro_torch.configs\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.launch.specs, repro_torch.launch.dryrun\n"
        "import repro_torch.sharding, repro_torch.sharding.rules\n"
        "import repro_torch.telemetry.hlo, repro_torch.telemetry.costprobe\n"
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


# ----------------------------------------------------------------------------
# Name coverage: every public name of a reference module resolves in its
# counterpart (the reference read as text, never imported)
# ----------------------------------------------------------------------------

REF = REPO / "src" / "repro"

#: reference modules with no counterpart file yet → the ROADMAP item that
#: brings them (queue 1); empty: every reference module has one
NOT_YET: dict = {}

#: names a counterpart leaves out on purpose, each with its reason
ABSENT = {
    ("api/executor.py", "cached_program"):
        "the port compiles nothing, so it caches no program (ROADMAP queue 3, item 20)",
    ("kernels/decode_attention/ops.py", "decode_attention_xla"):
        "the reference's 'bitwise mirror' of its kernel is not bitwise under jax 0.9.0; "
        "the port holds its kernel to ref.py (ROADMAP queue 3, item 1)",
    **{(f"kernels/{k}/kernel.py", f"{k}_fwd"):
        "the Pallas entry point; the port's kernel.py functions launch the CUDA kernels "
        "under their own names" for k in ("decode_attention", "flash_attention", "pdist_argmin")},
    ("telemetry/hlo.py", "parse_replica_groups"):
        "HLO text parsing; the port records collectives as they run",
}


def _public_names(path: Path) -> set:
    """``__all__`` and the public top-level functions and classes."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                out.add(node.name)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            out |= set(ast.literal_eval(node.value))
    return out


def _bound_names(path: Path) -> set:
    """Every name a module's top level binds (defs, assignments, imports)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


@pytest.mark.parametrize("rel", sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")))
def test_reference_names_resolve_in_the_port(rel):
    import importlib

    if rel in NOT_YET:
        assert not (PORT / rel).exists(), f"{rel} has a counterpart now: drop it from NOT_YET"
        pytest.skip(f"no counterpart yet: ROADMAP.md queue 1, {NOT_YET[rel]}")
    port = PORT / rel
    assert port.exists(), f"src/repro/{rel} has no counterpart src/repro_torch/{rel}"
    wanted = _public_names(REF / rel)
    absent = {n for (r, n) in ABSENT if r == rel}
    assert absent <= wanted, f"allow-list names {absent - wanted} are not in src/repro/{rel}"
    if port.name == "__init__.py":
        # a package's attributes include whatever submodules anyone imported:
        # read what its own __init__ binds
        have = _bound_names(port)
    else:
        mod = "repro_torch." + rel[:-3].replace("/", ".")
        have = set(dir(importlib.import_module(mod)))
    missing = sorted(wanted - absent - have)
    assert missing == [], f"src/repro_torch/{rel} lacks {missing}"
    assert not (absent & have), f"{sorted(absent & have)} resolve now: drop them from ABSENT"
