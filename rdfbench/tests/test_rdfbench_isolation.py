"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program; no run without a card."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imported(path: Path) -> set[str]:
    """Top-level names (before the first dot, whole) a module imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _modules(under: Path):
    return sorted(p for p in under.rglob("*.py") if "__pycache__" not in
                  p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(ROOT)): _imported(p) & FORBIDDEN
             for p in _modules(HERE)}
    assert not {k: v for k, v in found.items() if v}
    # the comparison is by whole names: the port's name begins with the
    # JAX package's and is allowed
    assert "repro_torch" in _imported(HERE / "harness.py") or \
        "repro_torch" in set().union(*map(_imported, _modules(HERE)))


def test_reference_imports_nothing_of_the_program():
    for p in _modules(HERE / "reference"):
        assert not _imported(p) & (FORBIDDEN | {"repro_torch", "torch"}), p


def test_forbidden_modules_compares_whole_names():
    from rdfbench.run import forbidden_modules

    assert forbidden_modules(["repro_torch", "repro_torch.core.engine",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["repro_torch", "repro.core.engine", "jax",
                              "jaxlib.xla_client", "flax"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_refuses_to_run_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "lubm100-w8-na.mix6-closed", "--seed", str(2**31 + 5), "--seconds",
         "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA card" in proc.stderr
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
