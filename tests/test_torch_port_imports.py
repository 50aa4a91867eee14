"""The PyTorch port stands alone: every module of ``sparknet_tpu_torch``
imports with ``jax``, ``google.protobuf`` and ``h5py`` blocked, and
neither the package nor ``chip_smoke.py`` names ``jax`` or
``sparknet_tpu`` in an import, nor ``google.protobuf`` or ``h5py`` (the
card's machine has neither: the wire codec is the port's own)."""

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
        "sys.modules['google.protobuf'] = None\n"
        "sys.modules['h5py'] = None\n"
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
    return (top in ("jax", "jaxlib", "sparknet_tpu", "h5py")
            or name == "google.protobuf"
            or name.startswith("google.protobuf."))


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


def test_forbidden_covers_protobuf_and_h5py():
    assert _forbidden("google.protobuf") and _forbidden("h5py")
    assert _forbidden("google.protobuf.text_format")
    assert not _forbidden("google") and not _forbidden("h5pyx")


def test_tools_are_scanned_and_caffe_cli_runs_with_jax_blocked(tmp_path):
    """The ``tools`` package is among the files the scans above cover,
    and ``caffe_cli`` trains and times a DummyData net on the CPU with
    ``jax`` and ``sparknet_tpu`` blocked (its imports are lazy, inside
    the actions, so importing the module alone would not show them)."""
    assert PKG / "tools" / "caffe_cli.py" in SOURCES
    assert "sparknet_tpu_torch.tools.caffe_cli" in _module_names()
    net = tmp_path / "net.prototxt"
    net.write_text(
        'layer { name: "d" type: "DummyData" top: "data" top: "label"\n'
        '  dummy_data_param { shape { dim: 4 dim: 3 } shape { dim: 4 }\n'
        '    data_filler { type: "gaussian" } } }\n'
        'layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"\n'
        '  inner_product_param { num_output: 2 } }\n'
        'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip"\n'
        '  bottom: "label" }\n')
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\nbase_lr: 0.1\nmax_iter: 2\n'
                      'display: 1\n')
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sparknet_tpu'] = None\n"
        "from sparknet_tpu_torch.tools import caffe_cli\n"
        f"assert caffe_cli.main(['train', '--solver', {str(solver)!r}, "
        "'--device', 'cpu']) == 0\n"
        f"assert caffe_cli.main(['time', '--model', {str(net)!r}, "
        "'--iterations', '1', '--device', 'cpu']) == 0\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'sparknet_tpu.')) for m in sys.modules if sys.modules[m])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Iteration 2, loss" in out.stdout
    assert "Average Forward-Backward" in out.stdout
