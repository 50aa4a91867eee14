"""The port's ImageNet tar loader, object store and ``imagenet_app
--tar-dir`` against the JAX package's, on the CPU.

Tars of the committed JPEG fixtures (``sparknet_tpu_torch/data/
jpeg_fixtures/``) with undecodable entries planted among them go through
both packages: ``index_tars`` entries, ``load_imagenet`` partitions, the
decoded images (the port's PIL + plain resize against libjpeg + the
native resize), ``dropped`` and ``decoded_count``, the app's mean image,
train rounds (``RoundFeed`` with ``random_crop_mirror``) and test batches
(``eval_feed`` with ``center_crop``) at resize 72 and crop 67, all equal
byte for byte (tolerance zero: the same libjpeg, the same float32
operations, the same float64 sums, the same seeded draws).
"""

from __future__ import annotations

import functools
import io
import json
import math
import pathlib
import tarfile

import numpy as np
import pytest
import torch

from sparknet_tpu import native
from sparknet_tpu.apps.common import RoundFeed as JaxRoundFeed
from sparknet_tpu.apps.common import eval_feed as jax_eval_feed
from sparknet_tpu.data import imagenet as jimagenet
from sparknet_tpu.data import objectstore as jstore
from sparknet_tpu.data import transforms as jax_transforms
from sparknet_tpu_torch.apps import imagenet_app
from sparknet_tpu_torch.apps.common import RoundFeed, eval_feed
from sparknet_tpu_torch.data import center_crop, imagenet, objectstore, \
    random_crop_mirror

FIXTURES = (pathlib.Path(__file__).resolve().parent.parent
            / "sparknet_tpu_torch" / "data" / "jpeg_fixtures")
RESIZE, CROP, CLASSES = 72, 67, 10


def _jpegs() -> list[bytes]:
    m = json.loads((FIXTURES / "manifest.json").read_text())
    names = [e["file"] for e in m["imagenet"].values()] + [
        "s420.jpg", "s444.jpg", "gray.jpg", "progressive.jpg",
        "restart.jpg", "truncated.jpg", "cmyk.jpg"]
    return [(FIXTURES / n).read_bytes() for n in names]


def write_tars(d: pathlib.Path, n_tars: int, per_tar: int, planted: set,
               seed: int) -> tuple[str, str]:
    """``n_tars`` tars of ``per_tar`` JPEGs each (the fixtures copied
    under distinct names), the records whose running index is in
    ``planted`` replaced by garbage bytes, a directory entry and an
    unlabeled file in the first tar; and the label file."""
    jpegs = _jpegs()
    rng = np.random.default_rng(seed)
    tar_dir = d / "tars"
    tar_dir.mkdir()
    lines, k = [], 0
    for t in range(n_tars):
        with tarfile.open(tar_dir / f"part{t:02d}.tar", "w") as tf:
            if t == 0:
                info = tarfile.TarInfo("subdir")
                info.type = tarfile.DIRTYPE
                tf.addfile(info)
                extra = b"not in the label map"
                info = tarfile.TarInfo("README")
                info.size = len(extra)
                tf.addfile(info, io.BytesIO(extra))
            for _ in range(per_tar):
                data = (b"\xff\xd8garbage" if k in planted
                        else jpegs[k % len(jpegs)])
                name = f"n{k:05d}.JPEG"
                info = tarfile.TarInfo(f"train/{name}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
                lines.append(f"train/{name} {int(rng.integers(CLASSES))}")
                k += 1
    labels = d / "labels.txt"
    labels.write_text("\n".join(lines) + "\n")
    return str(tar_dir), str(labels)


@pytest.fixture(scope="module")
def tars(tmp_path_factory):
    d = tmp_path_factory.mktemp("tars")
    return write_tars(d, 2, 12, planted={3, 17}, seed=0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_label_map_and_tar_listing_equal_jax(tars):
    tar_dir, labels = tars
    assert imagenet.read_label_map(labels) == jimagenet.read_label_map(
        labels)
    assert imagenet.list_tars(tar_dir) == jimagenet.list_tars(tar_dir)
    lm = imagenet.read_label_map(labels)
    path = imagenet.list_tars(tar_dir)[0]
    ours = list(imagenet.stream_tar_images(path, lm))
    assert ours == list(jimagenet.stream_tar_images(path, lm))
    got = [(img.tobytes(), lab) for img, lab in
           imagenet.decode_and_resize(iter(ours), RESIZE, device="cpu")]
    want = [(img.tobytes(), lab) for img, lab in
            jimagenet.decode_and_resize(iter(ours), RESIZE)]
    assert got == want and len(got) == len(ours) - 1   # the garbage


def test_local_store_equals_jax(tars):
    tar_dir, _ = tars
    store, prefix = objectstore.get_store("file://" + tar_dir)
    jst, jprefix = jstore.get_store(tar_dir)
    assert prefix == jprefix == ""
    assert store.list_keys() == jst.list_keys()
    key = store.list_keys()[0]
    assert store.size(key) == jst.size(key)
    assert store.open_range(key, 1000, 333) == jst.open_range(key, 1000, 333)
    with store.open(key) as f:
        assert f.read() == pathlib.Path(tar_dir, key).read_bytes()
    store.close()
    assert store.open_range(key, 5, 7) == jst.open_range(key, 5, 7)


@pytest.mark.parametrize("url", ["s3://bucket/imagenet", "gs://b/p"])
def test_remote_stores_name_their_item(url):
    with pytest.raises(NotImplementedError, match="ROADMAP A6, object store"):
        objectstore.get_store(url)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        imagenet.load_imagenet(url, "labels.txt", 2, device="cpu")


def _loaded(tars, workers=2, size=RESIZE):
    tar_dir, labels = tars
    return (imagenet.load_imagenet(tar_dir, labels, workers, size=size,
                                   device="cpu"),
            jimagenet.load_imagenet(tar_dir, labels, workers, size=size))


def test_index_and_partitions_equal_jax(tars):
    tar_dir, labels = tars
    assert imagenet.index_tars(tar_dir, labels) == jimagenet.index_tars(
        tar_dir, labels)
    ds, jds = _loaded(tars, workers=3)
    assert ds.partition_sizes() == jds.partition_sizes() == [8, 8, 8]
    for p, jp in zip(ds.partitions, jds.partitions):
        assert p.entries == jp.entries


def test_decoded_images_drops_and_counts_equal_jax(tars):
    ds, jds = _loaded(tars)
    for p, jp in zip(ds.partitions, jds.partitions):
        # slices (RoundFeed's access), single records and iteration, with
        # a planted entry read before and after the first decodable one
        for access in (lambda q: q[4:9], lambda q: q[0:3],
                       lambda q: [q[i] for i in range(len(q))],
                       lambda q: list(q)):
            got, want = access(p), access(jp)
            assert [(x.dtype, x.tobytes(), y) for x, y in got] == \
                [(x.dtype, x.tobytes(), y) for x, y in want]
        assert (p.dropped, p.decoded_count) == (jp.dropped,
                                                jp.decoded_count)
    assert sum(p.dropped for p in ds.partitions) > 0


def test_drop_substitutes_the_first_decodable_image_and_its_label(tars):
    ds, _ = _loaded(tars, workers=1)
    p = ds.partitions[0]
    bad = [i for i, e in enumerate(p.entries)
           if imagenet.decode_image(p.store.open_range(*e[:3]), RESIZE,
                                    "cpu") is None]
    first = next(i for i in range(len(p)) if i not in bad)
    for i in bad:
        img, label = p[i]
        want_img, want_label = p[first]
        assert img.tobytes() == want_img.tobytes()
        assert label == want_label == p.entries[first][3]


def test_a_partition_with_no_decodable_image_raises(tmp_path):
    tar_dir, labels = write_tars(tmp_path, 1, 3, planted={0, 1, 2}, seed=1)
    ds = imagenet.load_imagenet(tar_dir, labels, 1, size=8, device="cpu")
    with pytest.raises(RuntimeError, match="no image in this partition"):
        ds.partitions[0][0]


def test_tar_dir_mean_rounds_and_test_batches_equal_jax(tars):
    """The app's data path over ``--tar-dir``: the mean image (float64,
    chunks of 64, imagenet_app.py:140-149 of the JAX app), the train
    rounds and the test batches, byte for byte."""
    ds, jds = _loaded(tars)
    mean = imagenet_app.mean_image(ds)
    acc = np.zeros((3, RESIZE, RESIZE), np.float64)
    for p in jds.partitions:
        for i in range(0, len(p), 64):
            native.accumulate_mean(
                np.stack([x for x, _ in p[i:i + 64]]).astype(np.float32), acc)
    want_mean = (acc / jds.count()).astype(np.float32)
    assert mean.tobytes() == want_mean.tobytes()

    feed = RoundFeed(ds, 2, 3, seed=3, preprocess=functools.partial(
        random_crop_mirror, crop=CROP, rng=np.random.default_rng(7),
        mean=mean))
    jfeed = JaxRoundFeed(jds, 2, 3, seed=3, preprocess=functools.partial(
        jax_transforms.random_crop_mirror, crop=CROP,
        rng=np.random.default_rng(7), mean=mean))
    for _ in range(3):
        got, want = feed.next_round(), jfeed.next_round()
        assert got["data"].shape == (3, 4, 3, CROP, CROP)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
    raw = RoundFeed(ds, 2, 3, seed=5)            # --device-preprocess
    jraw = JaxRoundFeed(jds, 2, 3, seed=5)
    got, want = raw.next_round(), jraw.next_round()
    assert got["data"].tobytes() == want["data"].tobytes()

    factory, steps = eval_feed(ds, 2, functools.partial(
        center_crop, crop=CROP, mean=mean))
    jfactory, jsteps = jax_eval_feed(jds, 2, functools.partial(
        jax_transforms.center_crop, crop=CROP, mean=mean))
    assert steps == jsteps == 6
    for got, want in zip(factory(), jfactory()):
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
    for p, jp in zip(ds.partitions, jds.partitions):
        assert (p.dropped, p.decoded_count) == (jp.dropped,
                                                jp.decoded_count)


def test_imagenet_app_trains_from_tars_on_the_cpu(tars, tmp_path):
    tar_dir, labels = tars
    test_dir, test_labels = write_tars(tmp_path, 1, 8, planted={5}, seed=2)
    run = imagenet_app.main([
        "--tar-dir", tar_dir, "--label-file", labels,
        "--test-tar-dir", test_dir, "--test-label-file", test_labels,
        "--device", "cpu", "--workers", "2", "--batch", "2", "--tau", "2",
        "--rounds", "2", "--test-interval", "1", "--resize", str(RESIZE),
        "--crop", str(CROP), "--classes", str(CLASSES),
        "--device-preprocess"])
    tr = run.trainer
    assert tr.round == 2 and tr.iter == 4
    assert all(math.isfinite(v) for v in tr.round_losses.values())
    assert math.isfinite(run.scores["loss"])
    parts = run.feed._parts
    assert all(isinstance(p, imagenet.LazyTarPartition) for p in parts)
    assert sum(p.decoded_count for p in parts) >= 24   # the mean pass


def test_imagenet_app_tar_dir_needs_a_label_file(tars):
    with pytest.raises(SystemExit, match="--label-file"):
        imagenet_app.main(["--tar-dir", tars[0], "--device", "cpu"])
