"""The port stands alone: no module of `shallowspeed_tpu_torch`, and not
`chip_smoke.py`, imports `jax` or anything of `shallowspeed_tpu`
(checked on the source with an AST walk, so a lazy import inside a
function counts too)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "shallowspeed_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "shallowspeed_tpu")


@pytest.mark.parametrize("path", FILES, ids=[str(f.relative_to(ROOT))
                                             for f in FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [n for n in _imported(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_check_sees_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\n\ndef f():\n    from jax import numpy\n"
                   "    import shallowspeed_tpu.serving.cache\n"
                   "    import shallowspeed_tpu_torch\n")
    assert [n for n in _imported(src) if _forbidden(n)] == [
        "jax", "shallowspeed_tpu.serving.cache"]
