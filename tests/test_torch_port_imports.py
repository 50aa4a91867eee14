"""The PyTorch port stands alone: every module of ``sparknet_tpu_torch``
imports with ``jax``, ``google.protobuf``, ``h5py`` and ``pyspark``
blocked, and neither the package nor ``chip_smoke.py`` names ``jax`` or
``sparknet_tpu`` in an import, nor ``google.protobuf``, ``h5py`` or
``pyspark`` (the card's machine has none of them: the wire codec and the
HDF5 reader and writer are the port's own, and the Spark bridge runs on
the minimal RDD protocol).  The data tier (record shards, the convert
tool, HDF5 snapshots, the Spark bridge) runs with all of them blocked.  PIL is
imported only inside the CPU paths of ``data/jpeg.py``, matplotlib only
inside ``tools/plot_training_log.py``'s ``plot``, and
``imagenet_app --tar-dir`` trains with ``jax`` and ``sparknet_tpu``
blocked.  Caffe's tools and pycaffe's classifiers (``train_cifar``,
``parse_log``, ``upgrade_net_proto``, ``draw_net``, ``classify_cli`` and
``detect_cli`` on PNGs, ``pycaffe_io``, ``pycaffe_pb2``) run with all of
those and PIL and matplotlib blocked, as on the card's machine, and so do
the serving plane's ``tools/serve.py --help``, the model registry, the
beacons and ``import caffe`` through the port's shim, and the
observability and bench plane's tools (``knobs``, ``serveload``,
``feedbench``, ``roundbench``, ``obs``, ``perf_probe``) and the
profiler server; so do commbench's five gates and a chaos ship over the
host transport."""

from __future__ import annotations

import ast
import os
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


SLICE_MODULES = ["tools/upgrade_net_proto.py", "tools/draw_net.py",
                 "tools/parse_log.py", "tools/plot_training_log.py",
                 "tools/train_cifar.py", "data/png.py",
                 "data/pil_resample.py", "data/jpeg.py", "data/db.py",
                 "pycaffe_pb2.py", "pycaffe_io.py", "classify.py",
                 "tools/classify_cli.py", "tools/detect_cli.py"]


def _imports_of(path: pathlib.Path, top: str) -> list[tuple[int, str]]:
    """(line, enclosing function or "") of each import of ``top``."""
    tree = ast.parse(path.read_text(), str(path))
    owner = {}
    for f in ast.walk(tree):
        if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for n in ast.walk(f):
                owner.setdefault(id(n), f.name)
    found = []
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        if any(n.split(".")[0] == top for n in names):
            found.append((node.lineno, owner.get(id(node), "")))
    return found


# file -> the functions that may import matplotlib
MATPLOTLIB_INSIDE = {PKG / "tools" / "plot_training_log.py": {"plot"},
                     PKG / "tools" / "plot_learning_proxy.py":
                         {"render", "render_sweep"}}


def test_matplotlib_is_imported_only_inside_plot_training_logs_plot():
    """... and inside ``plot_learning_proxy``'s two drawing functions."""
    for path in SOURCES:
        found = _imports_of(path, "matplotlib")
        if path in MATPLOTLIB_INSIDE:
            assert found and {f for _, f in found} == \
                MATPLOTLIB_INSIDE[path], found
        else:
            assert not found, f"{path.relative_to(ROOT)} imports matplotlib"


def test_tools_and_classifiers_run_with_pil_and_matplotlib_blocked(
        tmp_path):
    """The slice's modules are among the files the scans above cover, and
    with ``jax``, ``sparknet_tpu``, ``google.protobuf``, ``h5py``,
    ``pyspark``, PIL and matplotlib blocked: ``upgrade_net_proto`` and
    ``draw_net`` run, ``train_cifar --synthetic`` trains on the Solver
    path and on two workers and its log parses, ``classify_cli`` and
    ``detect_cli`` score the committed PNG fixtures, and ``pycaffe_io``
    and ``pycaffe_pb2`` load, resize and serialize."""
    for rel in SLICE_MODULES:
        assert PKG / rel in SOURCES
    (tmp_path / "net.prototxt").write_text(
        'layer { name: "d" type: "MemoryData" top: "data" top: "label"\n'
        '  memory_data_param { batch_size: 4 channels: 3 height: 32\n'
        '  width: 32 } }\n'
        'layer { name: "pool" type: "Pooling" bottom: "data" top: "pool"\n'
        '  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }\n'
        'layer { name: "ip" type: "InnerProduct" bottom: "pool" top: "ip"\n'
        '  inner_product_param { num_output: 10 } }\n'
        'layer { name: "acc" type: "Accuracy" bottom: "ip" bottom: "label"\n'
        '  top: "accuracy" include { phase: TEST } }\n'
        'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip"\n'
        '  bottom: "label" }\n')
    (tmp_path / "solver.prototxt").write_text(
        f'net: "{tmp_path / "net.prototxt"}"\ntest_iter: 2\n'
        'test_interval: 4\nbase_lr: 0.001\nlr_policy: "fixed"\n'
        'display: 2\nmax_iter: 8\n')
    (tmp_path / "deploy.prototxt").write_text(
        'input: "data" input_shape { dim: 1 dim: 3 dim: 8 dim: 8 }\n'
        'layer { name: "n" type: "LRN" bottom: "data" top: "n" }\n'
        'layer { name: "ip" type: "InnerProduct" bottom: "n" top: "ip"\n'
        '  inner_product_param { num_output: 3 } }\n'
        'layer { name: "prob" type: "Softmax" bottom: "ip" top: "prob" }\n')
    pngs = PKG / "data" / "png_fixtures"
    (tmp_path / "pngs").mkdir()
    for name in ("pil_rgb.png", "pil_l.png", "t3_d4_adam7.png",
                 "t6_d16.png", "photo_375x500.png"):
        (tmp_path / "pngs" / name).write_bytes((pngs / name).read_bytes())
    (tmp_path / "windows.csv").write_text(
        "filename,ymin,xmin,ymax,xmax\n"
        f"{pngs / 'pil_rgb.png'},0,0,20,30\n"
        f"{pngs / 't0_d16_adam7.png'},2,2,12,15\n")
    t = str(tmp_path)
    code = (
        "import sys, contextlib, io\n"
        "for m in ('jax', 'sparknet_tpu', 'google.protobuf', 'h5py', "
        "'pyspark', 'PIL', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from sparknet_tpu_torch import pycaffe_io, pycaffe_pb2\n"
        "from sparknet_tpu_torch.tools import (classify_cli, detect_cli, "
        "draw_net, parse_log, train_cifar, upgrade_net_proto)\n"
        f"t = {t!r}\n"
        "assert upgrade_net_proto.main([t + '/net.prototxt', "
        "t + '/up.prototxt']) == 0\n"
        "assert draw_net.main([t + '/net.prototxt', t + '/n.dot']) == 0\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    train_cifar.main(['--solver', t + '/solver.prototxt', "
        "'--synthetic', '--device', 'cpu', '--out', t + '/a.json'])\n"
        "    train_cifar.main(['--solver', t + '/solver.prototxt', "
        "'--synthetic', '--device', 'cpu', '--workers', '2', '--tau', "
        "'2', '--out', t + '/b.json'])\n"
        "open(t + '/train.log', 'w').write(buf.getvalue())\n"
        "train, test = parse_log.parse_log(t + '/train.log')\n"
        "assert [r.iter for r in train][-1] == 8\n"
        "assert classify_cli.main([t + '/pngs', t + '/p.npy', "
        "'--model_def', t + '/deploy.prototxt', '--ext', 'png', "
        "'--images_dim', '10,10', '--device', 'cpu']) == 0\n"
        "assert np.load(t + '/p.npy').shape == (5, 3)\n"
        "assert detect_cli.main([t + '/windows.csv', t + '/d.csv', "
        "'--model_def', t + '/deploy.prototxt', '--context_pad', '2', "
        "'--device', 'cpu']) == 0\n"
        f"im = pycaffe_io.load_image({str(pngs / 'pil_la.png')!r}, "
        "device='cpu')\n"
        "assert pycaffe_io.resize_image(im, (5, 7)).shape == (5, 7, 3)\n"
        "d = pycaffe_io.array_to_datum(np.zeros((3, 2, 2), np.uint8), 1)\n"
        "m = pycaffe_pb2.Datum()\n"
        "m.ParseFromString(d.SerializeToString())\n"
        "assert m.label == 1\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'sparknet_tpu.', 'PIL', 'matplotlib', 'h5py', 'pyspark', "
        "'google.protobuf')) for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


DATA_PLANE_MODULES = ["native/__init__.py", "ops/augment.py",
                      "data/transforms.py", "tools/learning_proxy.py",
                      "tools/tausweep.py", "tools/plot_learning_proxy.py"]


def test_data_plane_and_proxy_run_with_jax_pil_and_matplotlib_blocked(
        tmp_path):
    """The native pipeline, the augmentation and the learning proxy's
    tools are among the files the scans above cover, and with ``jax``,
    ``sparknet_tpu``, ``google.protobuf``, ``h5py``, ``pyspark``, PIL and
    matplotlib blocked the native library builds and crops, a Solver
    trains through ``set_augment`` on the host and on the device path,
    and the learning proxy and the τ sweep run a few iterations on the
    CPU; the plot tool imports."""
    for rel in DATA_PLANE_MODULES:
        assert PKG / rel in SOURCES
    t = str(tmp_path)
    code = (
        "import sys\n"
        "for m in ('jax', 'sparknet_tpu', 'google.protobuf', 'h5py', "
        "'pyspark', 'PIL', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from sparknet_tpu_torch import native\n"
        "from sparknet_tpu_torch.models import lenet\n"
        "from sparknet_tpu_torch.ops.augment import AugmentSpec\n"
        "from sparknet_tpu_torch.proto import "
        "load_solver_prototxt_with_net\n"
        "from sparknet_tpu_torch.solvers import Solver\n"
        "from sparknet_tpu_torch.tools import (learning_proxy, "
        "plot_learning_proxy, tausweep)\n"
        "assert native.available(), native.build_error()\n"
        "assert native.crop_batch(np.ones((1, 1, 3, 3), np.float32), 2, "
        "[1], [0], [1]).shape == (1, 1, 2, 2)\n"
        "sp = load_solver_prototxt_with_net('base_lr: 0.01\\n', "
        "lenet(2, 2))\n"
        "b = {'data': np.full((2, 1, 30, 30), 9, np.uint8), "
        "'label': np.zeros(2, np.float32)}\n"
        "for dev in (True, False):\n"
        "    s = Solver(sp, device='cpu')\n"
        "    s.set_augment(AugmentSpec(crop=28, mirror=True), device=dev)\n"
        "    s.set_train_data(iter([b]))\n"
        "    assert np.isfinite(s.step(1))\n"
        f"t = {t!r}\n"
        "args = ['--scale', '35000', '--n-train', '200', '--n-test', "
        "'100', '--workers', '2', '--eval-every', '2', '--device', 'cpu', "
        "'--out', t + '/r.json']\n"
        "assert learning_proxy.main(args + ['--tau', '1']) == 0\n"
        "assert tausweep.main(args + ['--taus', '1', '--codecs', "
        "'none,int8', '--band', '1']) == 0\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'sparknet_tpu.', 'PIL', 'matplotlib', 'h5py', 'pyspark', "
        "'google.protobuf')) for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


SERVING_MODULES = ["parallel/registry.py", "parallel/health.py",
                   "parallel/serving.py", "tools/serve.py",
                   "pycaffe_compat.py", "pycaffe_netspec.py",
                   "classify.py", "ops/python_layer.py"]


def test_serving_plane_and_caffe_shim_run_with_jax_blocked(tmp_path):
    """The serving plane's and the ``caffe`` shim's modules are among the
    files the scans above cover, and with ``jax``, ``sparknet_tpu``,
    ``google.protobuf``, ``h5py``, ``pyspark``, PIL and matplotlib
    blocked: ``tools/serve.py --help`` runs, ``import caffe`` binds the
    port's shim, a NetSpec net runs forward and backward through
    ``caffe.Net`` on the CPU, a registry version publishes and a beat is
    written and read back."""
    for rel in SERVING_MODULES:
        assert PKG / rel in SOURCES
    help_out = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "for m in ('jax', 'sparknet_tpu', 'PIL', 'matplotlib'):\n"
         "    sys.modules[m] = None\n"
         "sys.argv = ['serve', '--help']\n"
         "from sparknet_tpu_torch.tools import serve\n"
         "serve.main()\n"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert help_out.returncode == 0, help_out.stderr
    assert "--device" in help_out.stdout and "--fleet" in help_out.stdout
    t = str(tmp_path)
    code = (
        "import sys\n"
        "for m in ('jax', 'sparknet_tpu', 'google.protobuf', 'h5py', "
        "'pyspark', 'PIL', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from sparknet_tpu_torch import pycaffe_compat\n"
        "pycaffe_compat.install()\n"
        "import caffe\n"
        "from caffe.proto import caffe_pb2\n"
        "assert caffe is pycaffe_compat\n"
        "caffe.set_mode_cpu()\n"
        "L, P = caffe.layers, caffe.params\n"
        "n = caffe.NetSpec()\n"
        "n.data = L.Input(shape=dict(dim=[2, 1, 8, 8]))\n"
        "n.conv = L.Convolution(n.data, num_output=3, kernel_size=3, "
        "weight_filler=dict(type='xavier'))\n"
        "n.pool = L.Pooling(n.conv, pool=P.Pooling.MAX, kernel_size=2, "
        "stride=2)\n"
        "n.ip = L.InnerProduct(n.pool, num_output=2)\n"
        "net = caffe.Net(str(n.to_proto()), phase=caffe.TEST)\n"
        "out = net.forward(data=np.ones((2, 1, 8, 8), np.float32))\n"
        "d = net.backward(ip=np.ones((2, 2), np.float32))\n"
        "assert out['ip'].shape == (2, 2) and d['data'].shape == "
        "(2, 1, 8, 8)\n"
        "from sparknet_tpu_torch.parallel import health, registry\n"
        f"net.save({t!r} + '/w.caffemodel')\n"
        f"reg = registry.ModelRegistry({t!r} + '/reg')\n"
        f"v = reg.publish('lenet', weights={t!r} + '/w.caffemodel')\n"
        "assert reg.weights_path('lenet', v).endswith('.caffemodel')\n"
        f"health.write_beat({t!r} + '/beats', 0, 1, 'serving')\n"
        f"assert health.read_all({t!r} + '/beats')[0].phase == 'serving'\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'sparknet_tpu.', 'PIL', 'matplotlib', 'h5py', 'pyspark', "
        "'google.protobuf')) for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


FUSION_MODULES = ["graph/fusion.py", "graph/tuner.py", "graph/net.py",
                  "tools/tune.py", "tools/fusebench.py",
                  "tools/perfwatch.py", "utils/trace_tables.py"]


def test_fusion_and_tuner_tools_run_with_jax_blocked(tmp_path):
    """The fusion pass's and the tuner's modules are among the files the
    scans above cover, and with ``jax``, ``sparknet_tpu``, PIL and
    matplotlib blocked: ``tools/tune.py tunebench`` and
    ``tools/fusebench.py`` pass on the CPU and ``tools/perfwatch.py
    --help`` runs."""
    for rel in FUSION_MODULES:
        assert PKG / rel in SOURCES
    block = ("import sys\n"
             "for m in ('jax', 'sparknet_tpu', 'PIL', 'matplotlib'):\n"
             "    sys.modules[m] = None\n")
    for tool, argv, want in (
            ("tune", ["tunebench", "--device", "cpu"], '"ok": true'),
            ("fusebench", ["--device", "cpu", "--batch", "2", "--iters",
                           "0"], '"ok": true'),
            ("perfwatch", ["--help"], "trajectory")):
        out = subprocess.run(
            [sys.executable, "-c",
             block + f"sys.argv = [{tool!r}, *{argv!r}]\n"
             f"from sparknet_tpu_torch.tools import {tool}\n"
             f"rc = {tool}.main()\n"
             "assert not any(m == 'jax' or m.startswith(('jax.', "
             "'sparknet_tpu.')) for m in sys.modules if sys.modules[m])\n"
             "sys.exit(rc)\n"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, (tool, out.stderr[-3000:])
        assert want in out.stdout, (tool, out.stdout[-2000:])


A13_TOOLS = ["knobs", "serveload", "feedbench", "roundbench", "obs",
             "perf_probe"]


def test_observability_and_bench_tools_run_with_jax_blocked():
    """The observability and bench plane's tools are among the files the
    scans above cover, and with ``jax``, ``sparknet_tpu``, PIL and
    matplotlib blocked each one's ``--help`` runs, ``tools/knobs
    --check`` passes and the profiler server answers a capture."""
    for tool in A13_TOOLS:
        assert PKG / "tools" / f"{tool}.py" in SOURCES
    assert PKG / "utils" / "profiling.py" in SOURCES
    code = (
        "import sys, contextlib, io\n"
        "for m in ('jax', 'sparknet_tpu', 'PIL', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for tool in {A13_TOOLS!r}:\n"
        "    mod = importlib.import_module("
        "'sparknet_tpu_torch.tools.' + tool)\n"
        "    out = io.StringIO()\n"
        "    with contextlib.redirect_stdout(out):\n"
        "        try:\n"
        "            mod.main(['--help'])\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, (tool, e.code)\n"
        "    assert 'usage' in out.getvalue(), tool\n"
        "from sparknet_tpu_torch.tools import knobs\n"
        "assert knobs.main(['--check']) == 0\n"
        "from sparknet_tpu_torch.utils import profiling\n"
        "with profiling.server(0) as srv:\n"
        "    assert 'traceEvents' in profiling.fetch_capture(srv.url, 5)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'sparknet_tpu.')) for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


FLEET_MODULES = ["tools/launch.py", "parallel/health.py",
                 "parallel/resilience.py", "parallel/cluster.py",
                 "tools/multihost_driver.py", "parallel/fleet.py",
                 "tools/fleet.py", "parallel/router.py",
                 "parallel/autoscale.py", "parallel/rollout.py",
                 "tools/serve.py", "tools/serveload.py", "tools/soak.py"]
FLEET_TOOLS = ["launch", "multihost_driver", "fleet", "serve", "serveload",
               "soak"]


def test_fleet_modules_are_scanned_and_tools_run_with_jax_blocked():
    """The fleet's modules are among the files the scans above cover,
    and with ``jax`` and ``sparknet_tpu`` blocked each fleet tool's
    ``--help`` runs and names ``--device``."""
    for rel in FLEET_MODULES:
        assert PKG / rel in SOURCES, rel
    code = (
        "import sys, contextlib, io, importlib\n"
        "for m in ('jax', 'sparknet_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for tool in {FLEET_TOOLS!r}:\n"
        "    mod = importlib.import_module("
        "'sparknet_tpu_torch.tools.' + tool)\n"
        "    out = io.StringIO()\n"
        "    with contextlib.redirect_stdout(out):\n"
        "        try:\n"
        "            mod.main(['--help'])\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, (tool, e.code)\n"
        "    assert '--device' in out.getvalue(), tool\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'sparknet_tpu.')) for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


NET_MODULES = ["parallel/transport.py", "tools/commbench.py",
               "tools/launch.py", "tools/soak.py"]


def test_transport_and_commbench_are_scanned_and_run_with_jax_blocked(
        tmp_path):
    """The host transport and commbench are among the files the scans
    above cover, and with ``jax`` and ``sparknet_tpu`` blocked commbench
    runs its five gates on the CPU and the transport ships a file over
    its chaos wrapper through a torn first attempt."""
    for rel in NET_MODULES:
        assert PKG / rel in SOURCES, rel
    src = tmp_path / "blob.bin"
    src.write_bytes(bytes(range(256)) * 64)
    code = (
        "import sys, contextlib, io\n"
        "for m in ('jax', 'sparknet_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from sparknet_tpu_torch.tools import commbench\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert commbench.main(['--rounds', '2', '--devices', '2', "
        "'--batch', '8', '--device', 'cpu']) == 0\n"
        "from sparknet_tpu_torch.parallel import transport\n"
        "from sparknet_tpu_torch.tools.soak import _TornOnceInjector\n"
        "t = transport.ChaosTransport(transport.LocalTransport(), "
        "injector=_TornOnceInjector())\n"
        f"rec = t.ship({str(src)!r}, 'b', {str(tmp_path / 'd' / 'b')!r})\n"
        "assert rec['bytes'] == 16384, rec\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'sparknet_tpu.')) for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1",
                              "SPARKNET_SHIP_CHUNK_MB": "0.001"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
    assert (tmp_path / "d" / "b").read_bytes() == src.read_bytes()
