"""The port stands alone: no module of it, and nothing in chip_smoke.py,
imports JAX or the JAX package.

Two checks: every module of the port imports in a fresh interpreter where
``import jax`` fails, and an AST scan finds no import of ``jax`` or of
``structure_plp_slam_tpu`` (exactly, or with its dot: the port's own name
starts with the same letters).
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "structure_plp_slam_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "structure_plp_slam_tpu" or name.startswith("structure_plp_slam_tpu."))


def test_every_module_imports_without_jax():
    modules = list(_module_names())
    assert len(modules) > 20
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['structure_plp_slam_tpu'] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_forbidden_name_check():
    assert _forbidden("jax.numpy") and _forbidden("structure_plp_slam_tpu.ops")
    assert not _forbidden("structure_plp_slam_tpu_torch.ops")
    assert not _forbidden("jaxtyping")
