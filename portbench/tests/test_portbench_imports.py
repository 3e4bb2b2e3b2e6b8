"""No module under ``portbench/`` imports JAX or the JAX package, and the
reference imports nothing of the port; the command refuses to run without
a card."""

import ast
import subprocess
import sys

import pytest

from portbench.tests.tiny import ROOT

BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path) -> set:
    """Every module name a file imports, in full."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_by_top_level_name(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_top_level_name_is_compared_whole():
    # the port's name begins with the JAX package's
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        for name in imported(path):
            top = name.split(".")[0]
            assert top != "repro_torch", (path, name)
            if top == "portbench":
                assert name.startswith("portbench.reference"), (path, name)


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "fit-epsilon-16sites-topk", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
