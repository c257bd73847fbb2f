"""The import boundary: nothing under portbench/ imports JAX or the JAX
package (top-level module names compared whole, since the port's name
begins with the JAX package's), and the reference imports nothing of the
program."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_sednn"}


def _sources(sub=""):
    base = os.path.join(ROOT, sub)
    for d, _, files in os.walk(base):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax(path):
    assert FORBIDDEN.isdisjoint(_imported_tops(path))


@pytest.mark.parametrize("path", list(_sources("reference")), ids=os.path.basename)
def test_reference_free_of_the_program(path):
    tops = set(_imported_tops(path))
    assert "tpu_sednn_torch" not in tops and FORBIDDEN.isdisjoint(tops)


def test_whole_names():
    """A name that merely begins with a forbidden one is not forbidden."""
    from portbench import harness

    assert "tpu_sednn_torch" not in harness.FORBIDDEN
    assert "tpu_sednn" in harness.FORBIDDEN
