"""The port's native host pipeline (``sparknet_tpu_torch/native``) against
its numpy paths and the JAX package's native library, on the CPU.

Every entry runs twice, once with the library built and once with the
numpy path forced (``get_lib`` patched to None), and each result equals
the JAX package's native entry bit for bit: the CIFAR decode, the
batched crop (no mean, one value, a crop-sized mean, an ``out``
buffer), the mean's float64 sums, the JPEG decode and resize (the
committed fixtures; undecodable bytes give None), the batched Datum
parse (raw and float Datums against the per-record decode; encoded,
malformed and mismatched batches give None, as does the numpy path).
Two processes building the library into one empty folder at once both
load it; without libjpeg's header (and past a library that does not
load) the other entries build and the JPEG decode takes the CPU path.
``DataTransformer.batch``, ``db_feed``, ``load_cifar10_binary`` and
``imagenet_app.mean_image`` give the same values with and without the
library, and the JAX package's.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from sparknet_tpu import native as jnative
from sparknet_tpu.data import cifar as jcifar
from sparknet_tpu.data import db as jdb
from sparknet_tpu.proto import load_net_prototxt as jax_load_net
from sparknet_tpu.proto.caffe_pb import Phase as JaxPhase
from sparknet_tpu_torch import native
from sparknet_tpu_torch.apps.imagenet_app import mean_image
from sparknet_tpu_torch.data import cifar, db
from sparknet_tpu_torch.data.lmdb_io import write_lmdb
from sparknet_tpu_torch.data.partition import PartitionedDataset
from sparknet_tpu_torch.proto import load_net_prototxt
from sparknet_tpu_torch.proto.caffe_pb import Phase
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "sparknet_tpu_torch" / "data" / "jpeg_fixtures"


@pytest.fixture(params=["built", "numpy"])
def mode(request, monkeypatch):
    if request.param == "built":
        assert native.available(), native.build_error()
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    return request.param


def same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_the_jax_library_builds_here():
    assert jnative.available()


def test_decode_cifar(mode):
    recs = np.random.default_rng(0).integers(0, 256, (7, 3073)
                                             ).astype(np.uint8)
    got, want = native.decode_cifar(recs), jnative.decode_cifar(recs)
    assert same(got[0], want[0]) and same(got[1], want[1])


MEANS = {"none": None, "scalar": 3.25,
         "crop_sized": np.random.default_rng(3).normal(
             size=(3, 8, 8)).astype(np.float32) * 40}


@pytest.mark.parametrize("mean", list(MEANS))
def test_crop_batch(mode, mean):
    rng = np.random.default_rng(1)
    batch = (rng.normal(size=(5, 3, 12, 14)) * 60).astype(np.float32)
    ys = rng.integers(0, 5, 5).astype(np.int32)
    xs = rng.integers(0, 7, 5).astype(np.int32)
    flips = rng.integers(0, 2, 5).astype(np.int32)
    want = jnative.crop_batch(batch, 8, ys, xs, flips, MEANS[mean])
    out = np.empty((5, 3, 8, 8), np.float32)
    got = native.crop_batch(batch, 8, ys, xs, flips, MEANS[mean], out=out)
    assert got is out and same(got, want)
    # one pixel off is told apart: the check sees a shifted crop
    shifted = native.crop_batch(batch, 8, ys, np.minimum(xs + 1, 6), flips,
                                MEANS[mean])
    assert not same(shifted, want)


def test_crop_batch_refuses_a_window_off_the_image(mode):
    batch = np.zeros((1, 1, 4, 4), np.float32)
    with pytest.raises(ValueError, match="leaves"):
        native.crop_batch(batch, 3, np.array([2], np.int32),
                          np.array([0], np.int32), np.array([0], np.int32))


def test_accumulate_mean(mode):
    rng = np.random.default_rng(2)
    imgs = (rng.normal(size=(9, 3, 5, 6)) * 77).astype(np.float32)
    start = rng.normal(size=(3, 5, 6)) * 1e3
    got, want = start.copy(), start.copy()
    native.accumulate_mean(imgs, got)
    jnative.accumulate_mean(imgs, want)
    assert same(got, want)
    with pytest.raises(ValueError, match="accumulator"):
        native.accumulate_mean(imgs, np.zeros((3, 5, 6), np.float32))


JPEGS = ["imagenet_0.jpg", "imagenet_5.jpg", "s420.jpg", "s422.jpg",
         "s444.jpg", "gray.jpg", "progressive.jpg", "restart.jpg",
         "truncated.jpg", "cmyk.jpg", "garbage.jpg", "header_only.jpg"]


@pytest.mark.parametrize("name", JPEGS)
def test_decode_jpeg_resize(mode, name):
    data = (FIXTURES / name).read_bytes()
    for h, w in ((37, 53), (64, 64)):
        got = native.decode_jpeg_resize(data, h, w)
        want = jnative.decode_jpeg_resize(data, h, w)
        if want is None:
            assert got is None
        else:
            assert same(got, want), (h, w)


def datums(n: int, shape=(3, 5, 4), seed=0, floats=False) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        if floats:
            img = img.astype(np.float32) + 0.5
        out.append(db.array_to_datum(img, int(rng.integers(0, 1000))))
    return out


@pytest.mark.parametrize("floats", [False, True], ids=["raw", "float"])
def test_parse_datum_batch(mode, floats):
    recs = datums(6, floats=floats)
    got = native.parse_datum_batch(recs, 3, 5, 4)
    if mode == "numpy":
        assert got is None   # the callers parse record by record
        return
    want = jnative.parse_datum_batch(recs, 3, 5, 4)
    assert same(got[0], want[0]) and same(got[1], want[1])
    per_record = [db.datum_to_array(r, device="cpu") for r in recs]
    assert same(got[0], np.stack([np.asarray(x, np.float32)
                                  for x, _ in per_record]))
    assert got[1].tolist() == [lbl for _, lbl in per_record]


def test_parse_datum_batch_refuses_what_it_cannot_parse():
    recs = datums(3)
    jpeg = (FIXTURES / "imagenet_0.jpg").read_bytes()
    for bad in ([*recs[:2], db.array_to_datum(None, 1, encoded=jpeg)],
                [*recs[:2], recs[2][:-5]],
                [*recs[:2], datums(1, shape=(3, 4, 4))[0]], []):
        assert native.parse_datum_batch(bad, 3, 5, 4) is None
        assert jnative.parse_datum_batch(bad, 3, 5, 4) is None


BUILD_SCRIPT = """
import sys
from pathlib import Path
from sparknet_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
assert native.available(), native.build_error()
x = native.crop_batch([[[[1., 2.], [3., 4.]]]], 1, [1], [1], [0])
assert x.tolist() == [[[[4.0]]]]
print("ok")
"""


def test_two_processes_build_into_one_folder(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert out.strip() == "ok"
    built = sorted(f.name for f in tmp_path.iterdir())
    assert len(built) == 1 and built[0].startswith("libsparknet_data-")
    assert built[0].endswith(".so")


def test_without_libjpeg_the_other_entries_build(tmp_path, monkeypatch):
    """A machine without libjpeg's header: the first variant fails to
    compile, the ``-DSN_NO_JPEG`` one builds, the four other entries run
    natively and ``decode_jpeg_resize`` gives libjpeg's values through
    ``data/jpeg.py``'s CPU decode."""
    missing = str(tmp_path / "no_such_dir" / "jpeglib.h")
    monkeypatch.setattr(native, "VARIANTS", ((["-include", missing],
                                              ["-ljpeg"]),
                                             native.VARIANTS[1]))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    assert native.available() and not native.jpeg_available()
    recs = np.random.default_rng(8).integers(0, 256, (3, 3073)
                                             ).astype(np.uint8)
    assert same(native.decode_cifar(recs)[0], jnative.decode_cifar(recs)[0])
    data = (FIXTURES / "s420.jpg").read_bytes()
    assert same(native.decode_jpeg_resize(data, 40, 30),
                jnative.decode_jpeg_resize(data, 40, 30))
    assert [f.suffix for f in tmp_path.iterdir() if f.is_file()] == [".so"]


def test_a_library_that_does_not_load_falls_through(tmp_path, monkeypatch):
    """A build output that does not load here (a library built on another
    machine) is passed over for the next variant."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    native._target(*native.VARIANTS[0]).write_bytes(b"not a library")
    assert native.available() and not native.jpeg_available()


TRANSFORMS = ["crop_size: 6 mirror: true mean_value: 10 mean_value: 20 "
              "mean_value: 30 scale: 0.5",
              "crop_size: 5", "mirror: true scale: 0.00390625"]


@pytest.mark.parametrize("transform", TRANSFORMS)
@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_transformer_and_db_feed_keep_their_values(mode, tmp_path, transform,
                                                   phase):
    path = str(tmp_path / "lmdb")
    recs = datums(20, shape=(3, 9, 8), seed=4)
    write_lmdb(path, [(b"%08d" % i, r) for i, r in enumerate(recs)])
    txt = (f'layer {{ name: "d" type: "Data" top: "data" top: "label" '
           f'transform_param {{ {transform} }} data_param {{ '
           f'source: "{path}" batch_size: 6 backend: LMDB }} }}\n')
    lp, jlp = load_net_prototxt(txt).layer[0], jax_load_net(txt).layer[0]
    feed = db.db_feed(lp, Phase[phase], seed=3, device="cpu")
    jfeed = jdb.db_feed(jlp, JaxPhase[phase], seed=3)
    for _ in range(5):
        b, jb = next(feed), next(jfeed)
        assert same(b["data"], jb["data"]) and same(b["label"], jb["label"])
    feed.close()
    jfeed.close()
    imgs = np.random.default_rng(6).integers(0, 256, (4, 3, 9, 8))
    tf = db.DataTransformer(lp.sub("transform_param"), Phase[phase], 8)
    jtf = jdb.DataTransformer(jlp.sub("transform_param"), JaxPhase[phase], 8)
    assert same(tf.batch(imgs), jtf.batch(imgs))


def test_cifar_binaries_and_the_mean_image_keep_their_values(mode, tmp_path):
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (30, 3, 32, 32)).astype(np.uint8)
    labels = rng.integers(0, 10, 30)
    path = str(tmp_path / "data_batch_1.bin")
    cifar.write_cifar10_binary(path, imgs, labels)
    got = cifar.load_cifar10_binary(path, shuffle=True, seed=2)
    want = jcifar.load_cifar10_binary(path, shuffle=True, seed=2)
    assert same(got[0], want[0]) and same(got[1], want[1])
    x = (rng.normal(size=(70, 3, 6, 6)) * 50 + 100).astype(np.float32)
    ds = PartitionedDataset.from_items(list(zip(x, range(70))), 3)
    acc = np.zeros((3, 6, 6), np.float64)
    for p in ds.partitions:   # the JAX app's sums (imagenet_app.py:127-134)
        for i in range(0, len(p), 64):
            jnative.accumulate_mean(
                np.stack([a for a, _ in p[i:i + 64]]).astype(np.float32), acc)
    assert same(mean_image(ds), (acc / 70).astype(np.float32))
