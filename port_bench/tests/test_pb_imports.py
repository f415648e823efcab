"""Import hygiene: nothing under port_bench imports JAX or the JAX package,
and the reference imports nothing of the program (top-level names compared
whole: dvc_tpu_torch is not dvc_tpu)."""

import ast

import pytest

from port_bench import common

FILES = sorted(common.BENCH_DIR.rglob("*.py"))


def top_level_imports(path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(common.BENCH_DIR)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(common.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (common.BENCH_DIR / "reference").rglob("*.py"):
        assert "dvc_tpu_torch" not in top_level_imports(path), path


def test_names_are_compared_whole():
    assert "dvc_tpu_torch".split(".")[0] not in common.FORBIDDEN
    import sys
    sys.modules.setdefault("dvc_tpu_torch_lookalike", sys)
    try:
        assert common.forbidden_loaded() == [m for m in common.FORBIDDEN if m in sys.modules]
    finally:
        sys.modules.pop("dvc_tpu_torch_lookalike", None)
