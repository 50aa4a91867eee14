"""The PyTorch port stands alone: every module of ``sparknet_tpu_torch``
imports with ``jax``, ``google.protobuf``, ``h5py`` and ``pyspark``
blocked, and neither the package nor ``chip_smoke.py`` names ``jax`` or
``sparknet_tpu`` in an import, nor ``google.protobuf``, ``h5py`` or
``pyspark`` (the card's machine has none of them: the wire codec and the
HDF5 reader and writer are the port's own, and the Spark bridge runs on
the minimal RDD protocol).  The data tier (record shards, the convert
tool, HDF5 snapshots, the Spark bridge) runs with all of them blocked.  PIL is
imported only inside the CPU paths of ``data/jpeg.py``, and
``imagenet_app --tar-dir`` trains with ``jax`` and ``sparknet_tpu``
blocked."""

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
        "sys.modules['pyspark'] = None\n"
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
    return (top in ("jax", "jaxlib", "sparknet_tpu", "h5py", "pyspark")
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
    assert _forbidden("pyspark") and _forbidden("pyspark.sql")
    assert not _forbidden("google") and not _forbidden("h5pyx")


DATA_TIER_MODULES = ["data/records.py", "data/spark_bridge.py",
                     "data/hdf5.py", "data/hdf5_format.py",
                     "data/mnist.py", "data/minibatch.py",
                     "data/synthgen.py", "data/partition.py",
                     "data/objectstore.py", "data/pipeline.py",
                     "tools/convert.py"]


def test_data_tier_is_scanned_and_runs_with_jax_and_h5py_blocked(
        tmp_path):
    """The data tier's modules are among the files the scans above
    cover, and with ``jax``, ``sparknet_tpu``, ``h5py`` and ``pyspark``
    blocked an LMDB converts to record shards through the convert tool, a
    net trains from them through ``caffe_cli`` and snapshots to HDF5, the
    HDF5 pair restores, and a fake RDD goes through the Spark bridge's
    spill."""
    for rel in DATA_TIER_MODULES:
        assert PKG / rel in SOURCES
    net = tmp_path / "net.prototxt"
    net.write_text(
        'layer { name: "d" type: "Data" top: "data" top: "label"\n'
        f'  data_param {{ source: "{tmp_path / "shards"}" batch_size: 4\n'
        '    backend: RECORDS } }\n'
        'layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"\n'
        '  inner_product_param { num_output: 3 } }\n'
        'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip"\n'
        '  bottom: "label" }\n')
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\nbase_lr: 0.1\nmax_iter: 3\n'
                      f'display: 1\nsnapshot_format: HDF5\n'
                      f'snapshot_prefix: "{tmp_path / "s"}"\n')
    code = (
        "import sys\n"
        "for m in ('jax', 'sparknet_tpu', 'h5py', 'pyspark'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from sparknet_tpu_torch.data.db import array_to_datum\n"
        "from sparknet_tpu_torch.data.lmdb_io import write_lmdb\n"
        "from sparknet_tpu_torch.data.spark_bridge import "
        "SparkPartitionBridge\n"
        "from sparknet_tpu_torch.tools import caffe_cli, convert\n"
        "rng = np.random.default_rng(0)\n"
        f"write_lmdb({str(tmp_path / 'lmdb')!r}, [(b'%08d' % i, "
        "array_to_datum(rng.integers(0, 256, (3, 4, 4)).astype(np.uint8), "
        "i % 3)) for i in range(12)])\n"
        f"assert convert.main(['--source', {str(tmp_path / 'lmdb')!r}, "
        f"'--out', {str(tmp_path / 'shards')!r}]) == 0\n"
        f"assert caffe_cli.main(['train', '--solver', {str(solver)!r}, "
        "'--device', 'cpu']) == 0\n"
        f"assert caffe_cli.main(['train', '--solver', {str(solver)!r}, "
        f"'--snapshot', {str(tmp_path / 's_iter_3.solverstate.h5')!r}, "
        "'--device', 'cpu']) == 0\n"
        "class RDD:\n"
        "    def __init__(self, p): self.p = p\n"
        "    def getNumPartitions(self): return len(self.p)\n"
        "    def coalesce(self, n): return RDD([sum(self.p, [])[i::n] "
        "for i in range(n)])\n"
        "    def mapPartitionsWithIndex(self, f): return RDD([list(f(i, "
        "iter(x))) for i, x in enumerate(self.p)])\n"
        "    def collect(self): return sum(self.p, [])\n"
        "ds = SparkPartitionBridge(RDD([list(range(10))]), 2)"
        f".to_local_dataset(spill_dir={str(tmp_path / 'spill')!r})\n"
        "assert ds.partition_sizes() == [5, 5]\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'sparknet_tpu.', 'h5py', 'pyspark')) for m in sys.modules "
        "if sys.modules[m])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Iteration 3, loss" in out.stdout
    assert "Resuming from" in out.stdout
    assert (tmp_path / "s_iter_3.caffemodel.h5").exists()


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


ROUND_MODULES = ["ops/quant.py", "parallel/comms.py", "parallel/mesh.py",
                 "utils/faults.py", "utils/checkpoint.py", "utils/knobs.py"]


def test_round_modules_are_scanned_and_the_round_runs_with_jax_blocked(
        tmp_path):
    """The round's modules are among the files the scans above cover,
    and a hierarchical int8 round with guarded, asynchronous round
    checkpoints and a resume runs on the CPU with ``jax`` and
    ``sparknet_tpu`` blocked."""
    for rel in ROUND_MODULES:
        assert PKG / rel in SOURCES
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sparknet_tpu'] = None\n"
        "import numpy as np\n"
        "from sparknet_tpu_torch.models import lenet\n"
        "from sparknet_tpu_torch.parallel import (DistributedTrainer, "
        "TrainerConfig, make_pod_mesh)\n"
        "from sparknet_tpu_torch.proto import "
        "load_solver_prototxt_with_net\n"
        "sp = load_solver_prototxt_with_net('base_lr: 0.01\\n', "
        "lenet(2, 2))\n"
        "cfg = TrainerConfig(strategy='hierarchical', tau=1, "
        "comm_codec='int8', guard_numerics=True, "
        f"checkpoint_dir={str(tmp_path)!r})\n"
        "b = {'data': np.ones((1, 8, 1, 28, 28), np.float32), "
        "'label': np.zeros((1, 8), np.float32)}\n"
        "tr = DistributedTrainer(sp, make_pod_mesh(2, 2), cfg, "
        "device='cpu')\n"
        "assert np.isfinite(tr.train_round(b))\n"
        "tr.flush_checkpoints()\n"
        "tr2 = DistributedTrainer(sp, make_pod_mesh(2, 2), cfg, "
        "device='cpu')\n"
        "assert tr2.round == 1\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'sparknet_tpu.')) for m in sys.modules if sys.modules[m])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "resume: restored round 1" in out.stderr


def _pil_imports(path: pathlib.Path) -> list[tuple[int, bool]]:
    """(line, inside a function) of each import of PIL in ``path``."""
    tree = ast.parse(path.read_text(), str(path))
    in_fn = {id(n) for f in ast.walk(tree)
             if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
             for n in ast.walk(f)}
    found = []
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        if any(n.split(".")[0] == "PIL" for n in names):
            found.append((node.lineno, id(node) in in_fn))
    return found


def test_pil_is_imported_only_inside_the_cpu_paths_of_data_jpeg():
    """The card's machine may lack PIL: only ``data/jpeg.py`` imports it,
    inside the function its CPU paths call, never at module level."""
    for path in SOURCES:
        found = _pil_imports(path)
        if path == PKG / "data" / "jpeg.py":
            assert found and all(inside for _, inside in found), found
        else:
            assert not found, f"{path.relative_to(ROOT)} imports PIL"


def test_imagenet_app_tar_dir_runs_with_jax_blocked(tmp_path):
    """``imagenet_app --tar-dir`` trains from a tar of the JPEG fixtures
    on the CPU with ``jax`` and ``sparknet_tpu`` blocked."""
    import io
    import tarfile
    fixtures = PKG / "data" / "jpeg_fixtures"
    jpegs = sorted(fixtures.glob("imagenet_*.jpg"))
    lines = []
    with tarfile.open(tmp_path / "t.tar", "w") as tf:
        for i in range(8):
            data = jpegs[i % len(jpegs)].read_bytes()
            info = tarfile.TarInfo(f"x{i}.JPEG")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
            lines.append(f"x{i}.JPEG {i % 3}")
    (tmp_path / "labels.txt").write_text("\n".join(lines) + "\n")
    argv = ["--tar-dir", str(tmp_path), "--label-file",
            str(tmp_path / "labels.txt"), "--device", "cpu", "--workers",
            "2", "--batch", "2", "--tau", "1", "--rounds", "1",
            "--resize", "72", "--crop", "67", "--classes", "3"]
    code = (
        "import sys, math\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sparknet_tpu'] = None\n"
        "from sparknet_tpu_torch.apps import imagenet_app\n"
        f"run = imagenet_app.main({argv!r})\n"
        "assert math.isfinite(run.trainer.round_losses[0])\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'sparknet_tpu.')) for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_python_layer_is_scanned_and_runs_with_jax_blocked():
    """``ops/python_layer.py`` is among the files the scans above cover,
    and a pycaffe-style numpy layer and a functional one run forward and
    backward in a net with ``jax``, ``sparknet_tpu`` and ``caffe``
    blocked: the adapter needs none of them."""
    assert PKG / "ops" / "python_layer.py" in SOURCES
    assert "sparknet_tpu_torch.ops.python_layer" in _module_names()
    code = (
        "import sys\n"
        "for m in ('jax', 'sparknet_tpu', 'caffe'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from sparknet_tpu_torch.graph import Net\n"
        "from sparknet_tpu_torch.ops import register_python_layer\n"
        "from sparknet_tpu_torch.proto import load_net_prototxt\n"
        "class Double:\n"
        "    def setup(self, bottom, top): pass\n"
        "    def reshape(self, bottom, top):\n"
        "        top[0].reshape(*bottom[0].data.shape)\n"
        "    def forward(self, bottom, top):\n"
        "        top[0].data[...] = 2 * bottom[0].data\n"
        "    def backward(self, top, down, bottom):\n"
        "        bottom[0].diff[...] = 2 * top[0].diff\n"
        "class Cube:\n"
        "    def out_shapes(self, s): return [tuple(s[0])]\n"
        "    def forward(self, x): return x ** 3\n"
        "register_python_layer('Double', Double)\n"
        "register_python_layer('Cube', Cube)\n"
        "net = Net(load_net_prototxt(\"\"\"\n"
        "input: 'x' input_shape { dim: 3 }\n"
        "layer { type: 'Python' name: 'd' bottom: 'x' top: 'd'\n"
        "  python_param { module: 'm' layer: 'Double' } }\n"
        "layer { type: 'Python' name: 'c' bottom: 'd' top: 'c'\n"
        "  python_param { module: 'm' layer: 'Cube' } }\"\"\"))\n"
        "x = torch.tensor([1.0, -2.0, 0.5], requires_grad=True)\n"
        "y = net.apply_all({}, {'x': x})['c']\n"
        "(g,) = torch.autograd.grad(y.sum(), x)\n"
        "assert torch.allclose(y, (2 * x) ** 3)\n"
        "assert torch.allclose(g, 24 * x.detach() ** 2)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'sparknet_tpu.')) for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
