"""Nothing under usbench/ imports JAX or the JAX package, and the reference
and the counts import nothing of the program; top-level module names are
compared whole (the port's name begins with the JAX package's)."""
import ast

import pytest

from usbench import spec

JAX_SIDE = {"jax", "jaxlib", "flax", "qups_tpu"}
PROGRAM = "qups_tpu_torch"


def _imports(path):
    """Top-level names of every module ``path`` imports, anywhere in it."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            out |= {a.value.split(".")[0] for a in node.args if isinstance(a, ast.Constant)}
    return out


SOURCES = sorted(spec.HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax_side_import(path):
    assert not _imports(path) & JAX_SIDE


@pytest.mark.parametrize("sub", ["reference", "counts", "inputs", "precisions"])
def test_yardstick_imports_nothing_of_the_program(sub):
    for path in (spec.HERE / sub).rglob("*.py"):
        assert PROGRAM not in _imports(path), path


def test_the_names_are_compared_whole():
    assert "qups_tpu_torch".split(".")[0] not in JAX_SIDE
    from usbench.run import forbidden_modules
    import sys

    sys.modules.setdefault("qups_tpu_torch_fake", sys)
    try:
        assert "qups_tpu" not in forbidden_modules()
    finally:
        sys.modules.pop("qups_tpu_torch_fake", None)
