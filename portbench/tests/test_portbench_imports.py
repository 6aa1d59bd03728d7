"""The benchmark imports no JAX and nothing of the JAX package; its reference
imports nothing of the program; it reads none of the repository's older
benchmark records."""
import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "gyroflow_tpu"}
OLD_RECORDS = ("BENCH_", "MULTICHIP_", "bench.py", "experiments")


def modules():
    return sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: Path):
    """Top-level names of every absolute import in the file (the part before
    the first dot, whole)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_walks_every_module():
    found = {p.relative_to(PKG).as_posix() for p in modules()}
    assert {"harness.py", "check.py", "reference/stabilizer.py",
            "reference/ops/remap.py", "metrics/ft_ms.render.py"} <= found


@pytest.mark.parametrize("path", modules(), ids=lambda p: p.relative_to(PKG).as_posix())
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


def test_whole_names_compared():
    # gyroflow_torch begins with the JAX package's name and is not it
    src = "import gyroflow_torch.core\nfrom gyroflow_torch import bench\n"
    tree_names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tree_names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tree_names.add(node.module.split(".")[0])
    assert tree_names == {"gyroflow_torch"} and not tree_names & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in modules() if "reference" in p.parts],
                         ids=lambda p: p.relative_to(PKG).as_posix())
def test_reference_imports_nothing_of_the_program(path):
    assert "gyroflow_torch" not in imported(path)
    assert imported(path) <= {"__future__", "bisect", "collections", "contextlib", "copy",
                              "dataclasses", "enum", "hashlib", "json", "logging", "math", "mmap",
                              "numpy", "random", "scipy", "struct", "sys", "torch", "typing",
                              "zlib"}


@pytest.mark.parametrize("path", [p for p in modules() if "tests" not in p.parts],
                         ids=lambda p: p.relative_to(PKG).as_posix())
def test_reads_no_older_records(path):
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    strings = [n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]
    assert not [s for s in strings if any(r in s for r in OLD_RECORDS)]


def test_a_run_holds_no_jax(small):
    from portbench import harness
    cell, cfg, traffic, metrics = small("gopro4k-preview")
    harness.run_cell(cfg, traffic, metrics, 11, 0.2, False, "cpu", harness.process_start())
    assert harness.forbidden_modules() == []
