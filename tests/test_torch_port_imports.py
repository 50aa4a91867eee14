"""The PyTorch port stands alone: every module of ``sparknet_tpu_torch``
imports with ``jax`` blocked, and neither the package nor ``chip_smoke.py``
names ``jax`` or ``sparknet_tpu`` in an import."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "sparknet_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names() -> list[str]:
    names = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sparknet_tpu'] = None\n"
        f"for name in {_module_names()!r}:\n"
        "    importlib.import_module(name)\n"
        "leaked = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'sparknet_tpu' or "
        "m.startswith('sparknet_tpu.'))\n"
        "assert all(sys.modules[m] is None for m in leaked), leaked\n"
        "print('ok', len(" + repr(_module_names()) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "sparknet_tpu")


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_matches_exact_module_names():
    # the port shares the JAX package's prefix: only the exact name counts
    assert _forbidden("sparknet_tpu") and _forbidden("sparknet_tpu.ops.vision")
    assert _forbidden("jax.numpy")
    assert not _forbidden("sparknet_tpu_torch.ops")
    assert not _forbidden("jaxtyping_like")
