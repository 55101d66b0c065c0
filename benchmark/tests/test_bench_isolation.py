"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: top-level names compared whole
(``rtm3d_tpu_torch`` begins with ``rtm3d_tpu`` and is not it)."""

import ast

import pytest

from conftest import ROOT

FILES = sorted((ROOT / "benchmark").rglob("*.py"))


def top_level_imports(path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "rtm3d_tpu"}


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "rtm3d_tpu_torch" not in top_level_imports(path)


def test_the_scan_tells_the_port_from_the_jax_package(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import rtm3d_tpu_torch.api\nfrom rtm3d_tpu_torch import config\n")
    assert top_level_imports(f) == {"rtm3d_tpu_torch"}
    f.write_text("from rtm3d_tpu.nn import model\n")
    assert top_level_imports(f) == {"rtm3d_tpu"}
