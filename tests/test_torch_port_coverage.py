"""The port does all the reference package does: a static check.

* Every module under ``src/repro/`` has a module of the same path under
  ``src/repro_torch/``, or is in :data:`LEFT_OUT` with its reason.
* Every file of ``examples/`` and ``scripts/`` that imports ``repro`` has a
  ``torch_`` copy beside it.
* Every reference ``benchmarks/*.py`` is in :data:`BENCHMARK_PR`: the
  port's benchmark copies are a benchmark change's work, not a bring-up
  slice's, and may be added beside them.
* Every ``examples/torch_*.py`` and ``scripts/torch_*.py`` imports neither
  ``jax`` nor ``repro`` (every import statement, at any depth).
"""

from __future__ import annotations

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

# reference module (path under src/repro) → why the port has none
LEFT_OUT = {
    "core/ref_numpy.py": "a numpy oracle that the port's tests import",
    "core/queries_jax.py": "its engines are in repro_torch/core/query_engine.py",
    "dist/compat.py": "jax version shims",
}

BENCHMARK_PR = {"common.py", "fidelity.py", "fig4_compactness.py", "fig5_speed.py",
                "fig6_scalability.py", "fig8_iterations.py", "kernelbench.py",
                "querybench.py", "roofline.py", "run.py", "table2_datasets.py"}


def imports(path: pathlib.Path) -> list[str]:
    """The top-level package every import statement of ``path`` names."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return [n.split(".")[0] for n in names]


def reference_modules() -> list[str]:
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def user_files() -> list[pathlib.Path]:
    return sorted(p for d in ("examples", "scripts") for p in (ROOT / d).glob("*.py")
                  if not p.name.startswith("torch_"))


def port_copies() -> list[pathlib.Path]:
    return sorted(p for d in ("examples", "scripts") for p in (ROOT / d).glob("torch_*.py"))


@pytest.mark.parametrize("module", reference_modules())
def test_every_reference_module_has_a_port_or_a_reason(module):
    assert (PORT / module).is_file() or module in LEFT_OUT, (
        f"src/repro/{module} has no src/repro_torch/{module} and no reason in LEFT_OUT")


def test_every_left_out_module_exists_and_its_stand_in_too():
    for module in LEFT_OUT:
        assert (REF / module).is_file() and not (PORT / module).exists(), module
    assert (PORT / "core" / "query_engine.py").is_file()


@pytest.mark.parametrize("path", user_files(), ids=lambda p: f"{p.parent.name}/{p.name}")
def test_every_example_and_script_that_imports_repro_has_a_torch_copy(path):
    if "repro" in imports(path):
        assert (path.parent / f"torch_{path.name}").is_file(), path


def reference_benchmarks() -> list[pathlib.Path]:
    """The reference's benchmark files: those that are not a port's copy
    (named ``torch_*`` or importing ``repro_torch``)."""
    return sorted(p for p in (ROOT / "benchmarks").glob("*.py")
                  if not p.name.startswith("torch_") and "repro_torch" not in imports(p))


@pytest.mark.parametrize("path", reference_benchmarks(), ids=lambda p: p.name)
def test_every_reference_benchmark_is_the_benchmark_prs(path):
    assert path.name in BENCHMARK_PR, path


def test_every_benchmark_named_for_the_benchmark_pr_exists():
    assert all((ROOT / "benchmarks" / name).is_file() for name in BENCHMARK_PR)


@pytest.mark.parametrize("path", port_copies(), ids=lambda p: f"{p.parent.name}/{p.name}")
def test_the_torch_copies_import_neither_jax_nor_the_reference(path):
    names = imports(path)
    assert not {"jax", "jaxlib", "repro"} & set(names), path
    assert "repro_torch" in names or "torch" in names, path
