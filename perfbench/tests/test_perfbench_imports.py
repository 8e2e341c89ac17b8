"""What the benchmark may load: no module under perfbench/ imports JAX
or the JAX package, and the references import nothing of the port.
Names are compared by their whole top-level part (the port's name
begins with the JAX package's)."""

import ast

import pytest

from perfbench.harness import common, manifest

FILES = sorted(manifest.BENCH.rglob("*.py"))
PORT = "objectdetectionpl_tpu_torch"


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(manifest.BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(common.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((manifest.BENCH / "reference")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert PORT not in names
    assert names <= {"__future__", "math", "typing", "numpy", "torch",
                     "perfbench"}


def test_the_port_is_not_the_jax_package():
    assert PORT not in common.FORBIDDEN
    assert PORT.split(".")[0] != "objectdetectionpl_tpu"


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(manifest.BENCH)))
def test_reads_no_old_benchmark(path):
    old = ("bench" + "marks/", "BENCH" + "_r0", "import " + "bench\n")
    assert not any(o in path.read_text() for o in old)
