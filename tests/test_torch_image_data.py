"""The port's image data paths against the JAX package's, on the CPU:
encoded Datums, ``load_image``, the ``ImageData`` and ``WindowData``
feeds and layers, ``convert_imageset``, and ``caffe_cli train`` on an
encoded LMDB and on an ImageData net.

Tolerances: zero for decoded pixels, batches, layer shapes and database
bytes (the port decodes with PIL's libjpeg and the plain resize, the JAX
package with libjpeg and its native resize: the same bits; the window
warp runs in float64 in both; the draws come from the same seeded
``default_rng``).  The CLIs' losses agree to rtol 1e-4, as
tests/test_torch_caffe_cli.py holds them.
"""

from __future__ import annotations

import io
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from sparknet_tpu.data import db as jdb
from sparknet_tpu.graph import Net as JaxNet
from sparknet_tpu.proto import NetState as JaxNetState
from sparknet_tpu.proto import load_net_prototxt as jax_load_net
from sparknet_tpu.proto.caffe_pb import Phase as JaxPhase
from sparknet_tpu.tools import caffe_cli as jax_cli
from sparknet_tpu.tools import compute_image_mean as jax_mean
from sparknet_tpu.tools import convert_imageset as jax_convert
from sparknet_tpu_torch.data import db, jpeg
from sparknet_tpu_torch.data.integrity import DataCorruptionError
from sparknet_tpu_torch.data.leveldb_io import LeveldbReader
from sparknet_tpu_torch.data.lmdb_io import LmdbReader
from sparknet_tpu_torch.graph.net import Net
from sparknet_tpu_torch.proto import NetState, Phase, load_net_prototxt
from sparknet_tpu_torch.tools import caffe_cli, compute_image_mean, \
    convert_imageset

FIXTURES = (pathlib.Path(__file__).resolve().parent.parent
            / "sparknet_tpu_torch" / "data" / "jpeg_fixtures")
SMALL = ["s420.jpg", "s422.jpg", "s444.jpg", "gray.jpg", "progressive.jpg",
         "restart.jpg", "truncated.jpg"]


def _read(name: str) -> bytes:
    return (FIXTURES / name).read_bytes()


def _png(seed: int) -> bytes:
    from PIL import Image
    arr = np.random.default_rng(seed).integers(0, 256, (21, 17, 3),
                                               dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A root folder of the small JPEG fixtures, one ImageNet-sized one,
    a PNG, a CMYK JPEG and a JPEG cut short, and list files naming the
    first seven, relative to it, and some of the others."""
    d = tmp_path_factory.mktemp("images")
    root = d / "root"
    (root / "sub").mkdir(parents=True)
    names = []
    listed = [n for n in SMALL if n != "truncated.jpg"] + ["imagenet_7.jpg"]
    for i, n in enumerate(listed):
        rel = f"sub/img{i}.jpg"
        (root / rel).write_bytes(_read(n))
        names.append(rel)
    (root / "sub/other.png").write_bytes(_png(0))
    (root / "sub/cmyk.jpg").write_bytes(_read("cmyk.jpg"))
    (root / "sub/cut.jpg").write_bytes(_read("truncated.jpg"))
    lines = [f"{n} {i % 3}" for i, n in enumerate(names)]
    (d / "list.txt").write_text("\n".join(lines) + "\n")
    (d / "mixed.txt").write_text("\n".join(
        lines[:3] + ["sub/other.png 1", "sub/cmyk.jpg 2"]) + "\n")
    return d, root


# ---------------------------------------------------------------------------
# Encoded Datums and load_image
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SMALL + ["imagenet_2.jpg"])
@pytest.mark.parametrize("hw", [(0, 0), (24, 31), (256, 256)])
def test_encoded_datum_decodes_as_jax(name, hw):
    data = _read(name)
    raw = db.array_to_datum(None, 5, encoded=data)
    assert raw == jdb.array_to_datum(None, 5, encoded=data)
    if hw != (0, 0):   # a Datum with its height and width set
        from sparknet_tpu_torch.proto.wireformat import decode, encode
        m = decode(raw, "Datum")
        m.set("height", hw[0])
        m.set("width", hw[1])
        raw = encode(m, "Datum")
    if name == "truncated.jpg" and hw == (0, 0):
        # at its own size the JAX package reads a cut scan with PIL,
        # which refuses it
        with pytest.raises(DataCorruptionError) as ours:
            db.datum_to_array(raw, device="cpu")
        with pytest.raises(Exception) as theirs:
            jdb.datum_to_array(raw)
        assert str(ours.value) == str(theirs.value)
        return
    got, label = db.datum_to_array(raw, device="cpu")
    want, jlabel = jdb.datum_to_array(raw)
    assert label == jlabel == 5
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert db.datum_shape(raw) == want.shape


@pytest.mark.parametrize("name", ["garbage.jpg", "header_only.jpg"])
def test_undecodable_sized_datum_raises_as_jax(name):
    from sparknet_tpu.proto.wireformat import decode, encode
    raw = jdb.array_to_datum(None, 1, encoded=_read(name))
    m = decode(raw, "Datum")
    m.set("height", 8)
    m.set("width", 8)
    raw = encode(m, "Datum")
    with pytest.raises(DataCorruptionError) as ours:
        db.datum_to_array(raw, key=b"k", source="s", device="cpu")
    with pytest.raises(Exception) as theirs:
        jdb.datum_to_array(raw, key=b"k", source="s")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("new_hw", [(0, 0), (19, 23), (64, 64)])
@pytest.mark.parametrize("color", [True, False])
def test_load_image_equals_jax(images, new_hw, color):
    _, root = images
    for path in sorted((root / "sub").iterdir()):
        if path.name == "cut.jpg" and new_hw == (0, 0):
            # at its own size a cut scan goes to PIL, which refuses it
            with pytest.raises(jpeg.UndecodableImage, match="truncated"):
                db.load_image(str(path), *new_hw, color, device="cpu")
            with pytest.raises(OSError, match="truncated"):
                jdb.load_image(str(path), *new_hw, color)
            continue
        got = db.load_image(str(path), *new_hw, color, device="cpu")
        want = jdb.load_image(str(path), *new_hw, color)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path


# ---------------------------------------------------------------------------
# The ImageData feed and layer
# ---------------------------------------------------------------------------

IMAGE_NET = """
layer {{ name: "data" type: "ImageData" top: "data" top: "label"
  transform_param {{ {transform} }}
  image_data_param {{ source: "{source}" root_folder: "{root}/"
                     batch_size: {batch} {params} }} }}
"""

IMAGE_CASES = {
    "plain_resize": ("", "new_height: 16 new_width: 20"),
    "shuffle_crop_mirror": ("crop_size: 12 mirror: true",
                            "new_height: 16 new_width: 16 shuffle: true"),
    "gray_mean_scale": ("mean_value: 100 scale: 0.5",
                        "new_height: 10 new_width: 9 is_color: false"),
    "means_per_channel": ("mean_value: 90 mean_value: 110 mean_value: 120 "
                          "crop_size: 20", "new_height: 24 new_width: 24"),
    "natural_size": ("crop_size: 24", ""),
    "natural_gray": ("crop_size: 20 mirror: true", "is_color: false"),
}


def _image_lp(images, case, batch=3, source="list.txt"):
    d, root = images
    transform, params = IMAGE_CASES[case]
    text = IMAGE_NET.format(transform=transform, source=d / source,
                            root=root, batch=batch, params=params)
    return load_net_prototxt(text).layer[0], jax_load_net(text).layer[0]


@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_image_data_feed_equals_jax(images, case, phase):
    """Five batches of 3 over 7 images: the list wraps mid-batch (and
    reshuffles, with ``shuffle``)."""
    lp, jlp = _image_lp(images, case)
    feed = db.image_data_feed(lp, Phase[phase], seed=4, device="cpu")
    jfeed = jdb.image_data_feed(jlp, JaxPhase[phase], seed=4)
    for _ in range(5):
        got, want = next(feed), next(jfeed)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("case", ["plain_resize", "gray_mean_scale",
                                  "natural_size", "natural_gray"])
def test_image_data_layer_shapes_equal_jax(images, case):
    lp, jlp = _image_lp(images, case)
    text = IMAGE_NET.format(
        transform=IMAGE_CASES[case][0], source=images[0] / "list.txt",
        root=images[1], batch=3, params=IMAGE_CASES[case][1])
    ours = Net(load_net_prototxt(text), NetState(Phase.TRAIN))
    theirs = JaxNet(jax_load_net(text), JaxNetState(JaxPhase.TRAIN))
    assert ours.blob_shapes == {k: tuple(v) for k, v in
                                theirs.blob_shapes.items()}


def test_image_data_on_a_png_and_a_cmyk_jpeg_equals_jax(images):
    """The JAX package's PIL path, on the CPU: a PNG, and a CMYK JPEG
    libjpeg refuses, read with PIL and resized by its BILINEAR filter."""
    d, root = images
    text = IMAGE_NET.format(transform="", source=d / "mixed.txt", root=root,
                            batch=5, params="new_height: 14 new_width: 14")
    got = next(db.image_data_feed(load_net_prototxt(text).layer[0],
                                  Phase.TRAIN, device="cpu"))
    want = next(jdb.image_data_feed(jax_load_net(text).layer[0],
                                    JaxPhase.TRAIN))
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


# ---------------------------------------------------------------------------
# The WindowData feed and layer
# ---------------------------------------------------------------------------

def _window_file(d: pathlib.Path, root: pathlib.Path) -> pathlib.Path:
    """R-CNN's window file over three images: windows inside, across the
    edges and past them, foreground and background overlaps."""
    rng = np.random.default_rng(9)
    blocks = []
    for i, name in enumerate(["sub/img6.jpg", "sub/img0.jpg",
                              "sub/img5.jpg"]):
        h, w = jpeg.jpeg_size((root / name).read_bytes())
        wins = []
        for _ in range(6):
            x1, y1 = int(rng.integers(-5, w - 4)), int(rng.integers(-5, h - 4))
            x2 = int(min(x1 + rng.integers(3, w), w + 6))
            y2 = int(min(y1 + rng.integers(3, h), h + 6))
            wins.append(f"{int(rng.integers(1, 5))} "
                        f"{rng.uniform(0, 1):.3f} {max(x1, 0)} {max(y1, 0)} "
                        f"{min(x2, w - 1)} {min(y2, h - 1)}")
        blocks.append(f"# {i}\n{root / name}\n3 {h} {w}\n{len(wins)}\n"
                      + "\n".join(wins))
    path = d / "windows.txt"
    path.write_text("\n".join(blocks) + "\n")
    return path


WINDOW_NET = """
layer {{ name: "data" type: "WindowData" top: "data" top: "label"
  transform_param {{ {transform} }}
  window_data_param {{ source: "{source}" batch_size: 5
    fg_threshold: 0.5 bg_threshold: 0.5 fg_fraction: 0.4 {params} }} }}
"""

WINDOW_CASES = {
    "warp": ("crop_size: 24", ""),
    "context_pad_mirror_mean": ("crop_size: 24 mirror: true mean_value: 104 "
                                "mean_value: 117 mean_value: 123",
                                "context_pad: 4"),
    "square_scale": ("crop_size: 20 scale: 0.25",
                     'crop_mode: "square" context_pad: 2'),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_window_data_feed_equals_jax(images, case, phase):
    d, root = images
    transform, params = WINDOW_CASES[case]
    text = WINDOW_NET.format(transform=transform,
                             source=_window_file(d, root), params=params)
    feed = db.window_data_feed(load_net_prototxt(text).layer[0],
                               Phase[phase], seed=2, device="cpu")
    jfeed = jdb.window_data_feed(jax_load_net(text).layer[0],
                                 JaxPhase[phase], seed=2)
    for _ in range(4):
        got, want = next(feed), next(jfeed)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k
    ours = Net(load_net_prototxt(text), NetState(Phase[phase]))
    theirs = JaxNet(jax_load_net(text), JaxNetState(JaxPhase[phase]))
    assert ours.blob_shapes == {k: tuple(v) for k, v in
                                theirs.blob_shapes.items()}


@pytest.mark.parametrize("args", [
    (3, 5, 40, 30, 24, 0, False, False), (0, 0, 46, 36, 24, 4, False, True),
    (-3, 2, 20, 50, 20, 2, True, True), (10, 10, 11, 12, 24, 8, True, False),
    (5, 5, 40, 20, 30, 7, True, True)])
def test_crop_warp_window_equals_jax(args):
    x1, y1, x2, y2, crop, pad, square, mirror = args
    img = np.random.default_rng(1).uniform(0, 255, (3, 37, 53)).astype(
        np.float32)
    mean = np.asarray([100, 110, 120], np.float32).reshape(3, 1, 1)
    got = db._crop_warp_window(img, max(x1, 0), max(y1, 0), x2, y2, crop,
                               pad, square, mirror, mean, 0.5)
    want = jdb._crop_warp_window(img, max(x1, 0), max(y1, 0), x2, y2, crop,
                                 pad, square, mirror, mean, 0.5)
    assert got.tobytes() == want.tobytes()


def test_warp_is_float64_like_jax():
    win = np.random.default_rng(3).uniform(0, 255, (3, 13, 29)).astype(
        np.float32)
    for oh, ow in ((13, 29), (7, 40), (1, 5), (31, 11)):
        assert db._warp(win, oh, ow).tobytes() == jdb._warp(
            win, oh, ow).tobytes()


def test_read_window_file_and_image_list_equal_jax(images):
    d, root = images
    path = str(_window_file(d, root))
    assert db.read_window_file(path, 0.5, 0.3) == jdb.read_window_file(
        path, 0.5, 0.3)
    assert db.read_image_list(str(d / "list.txt"), str(root)) == \
        jdb.read_image_list(str(d / "list.txt"), str(root))


# ---------------------------------------------------------------------------
# convert_imageset, compute_image_mean and the CLI
# ---------------------------------------------------------------------------

def _db_items(path: str, backend: str):
    reader = LmdbReader(path) if backend == "lmdb" else LeveldbReader(path)
    with reader as r:
        return list(r.items())


@pytest.mark.parametrize("flags", [
    ["--encoded"], ["--resize_height", "16", "--resize_width", "12"],
    ["--gray", "--shuffle"], ["--backend", "leveldb", "--encoded"],
    ["--backend", "leveldb", "--resize_height", "9", "--resize_width",
     "9", "--gray"]])
def test_convert_imageset_equals_the_jax_tool(images, tmp_path, flags,
                                              capsys):
    d, root = images
    args = [str(root) + "/", str(d / "list.txt")]
    convert_imageset.main(args + [str(tmp_path / "ours")] + flags
                          + ["--device", "cpu"])
    jax_convert.main(args + [str(tmp_path / "theirs")] + flags)
    backend = "leveldb" if "leveldb" in flags else "lmdb"
    got = _db_items(str(tmp_path / "ours"), backend)
    assert len(got) == 7
    assert got == _db_items(str(tmp_path / "theirs"), backend)
    out = capsys.readouterr().out
    assert out.count("processed 7 files total (0 skipped)") == 2


def test_convert_imageset_skips_what_it_cannot_read(images, tmp_path,
                                                    capsys):
    d, root = images
    lst = tmp_path / "l.txt"
    lst.write_text("sub/img0.jpg 0\nsub/missing.jpg 1\nsub/img1.jpg 2\n")
    convert_imageset.main([str(root) + "/", str(lst), str(tmp_path / "o"),
                           "--resize_height", "8", "--resize_width", "8",
                           "--device", "cpu"])
    jax_convert.main([str(root) + "/", str(lst), str(tmp_path / "t")])
    assert len(_db_items(str(tmp_path / "o"), "lmdb")) == 2
    assert "(1 skipped)" in capsys.readouterr().out


@pytest.fixture(scope="module")
def encoded_lmdb(images, tmp_path_factory):
    """An LMDB of 8 encoded ImageNet-sized JPEGs of one size (the
    fixtures' 500x375 ones, twice each), as convert_imageset --encoded
    writes them."""
    d = tmp_path_factory.mktemp("enc")
    m = json.loads((FIXTURES / "manifest.json").read_text())
    same = [e["file"] for e in m["imagenet"].values()
            if (e["height"], e["width"]) == (375, 500)]
    lines = []
    for i in range(8):
        (d / f"e{i}.jpg").write_bytes(_read(same[i % len(same)]))
        lines.append(f"e{i}.jpg {i % 3}")
    (d / "list.txt").write_text("\n".join(lines) + "\n")
    convert_imageset.main([str(d) + "/", str(d / "list.txt"),
                           str(d / "lmdb"), "--encoded", "--device", "cpu"])
    return d / "lmdb"


def test_compute_image_mean_of_encoded_datums_equals_the_jax_tool(
        encoded_lmdb, tmp_path, capsys):
    compute_image_mean.main([str(encoded_lmdb), str(tmp_path / "m.bp"),
                             "--device", "cpu"])
    jax_mean.main([str(encoded_lmdb), str(tmp_path / "j.bp")])
    assert (tmp_path / "m.bp").read_bytes() == (tmp_path / "j.bp").read_bytes()


ENCODED_NET = """
layer {{ name: "data" type: "Data" top: "data" top: "label"
  transform_param {{ crop_size: 16 mirror: true mean_value: 120 scale: 0.02 }}
  data_param {{ source: "{db}" batch_size: 4 backend: LMDB }} }}
layer {{ name: "pool" type: "Pooling" bottom: "data" top: "pool"
  pooling_param {{ pool: AVE kernel_size: 4 stride: 4 }} }}
layer {{ name: "ip" type: "InnerProduct" bottom: "pool" top: "ip"
  inner_product_param {{ num_output: 3 weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" include {{ phase: TRAIN }} }}
layer {{ name: "acc" type: "Accuracy" bottom: "ip" bottom: "label"
  top: "acc" include {{ phase: TEST }} }}
"""

SOLVER = """net: "{model}"
base_lr: 0.01
momentum: 0.9
lr_policy: "fixed"
max_iter: 4
display: 1
test_iter: 1
test_interval: 2
"""


def _losses(out: str) -> dict[int, float]:
    """Each iteration's first logged loss."""
    got: dict[int, float] = {}
    for a, b in re.findall(r"Iteration (\d+), loss = ([-\d.e+]+)", out):
        got.setdefault(int(a), float(b))
    return got


def _cli_pair(tmp_path, capsys, net_text: str) -> tuple[str, str]:
    model = tmp_path / "net.prototxt"
    model.write_text(net_text)
    init = tmp_path / "init.caffemodel"
    from sparknet_tpu_torch.proto import save_caffemodel
    net = Net(load_net_prototxt(str(model)), NetState(Phase.TRAIN))
    save_caffemodel(str(init), net.init(torch.Generator().manual_seed(3),
                                        device="cpu"))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(SOLVER.format(model=model))
    outs = []
    for main, extra in ((caffe_cli.main, ["--device", "cpu"]),
                        (jax_cli.main, [])):
        capsys.readouterr()
        assert main(["train", "--solver", str(solver), "--weights",
                     str(init)] + extra) == 0
        outs.append(capsys.readouterr().out)
    return outs[0], outs[1]


def _assert_tracks(ours: str, theirs: str):
    a, b = _losses(ours), _losses(theirs)
    assert list(a) == list(b) == [1, 2, 3, 4]
    np.testing.assert_allclose(list(a.values()), list(b.values()),
                               rtol=1e-4)
    ta = re.findall(r"Test net output: (\S+) = ([-\d.e+]+)", ours)
    assert ta == re.findall(r"Test net output: (\S+) = ([-\d.e+]+)", theirs)


def test_caffe_cli_trains_on_encoded_datums_as_the_jax_cli(
        encoded_lmdb, tmp_path, capsys):
    ours, theirs = _cli_pair(tmp_path, capsys,
                             ENCODED_NET.format(db=encoded_lmdb))
    assert "Optimization Done." in ours
    _assert_tracks(ours, theirs)


def test_caffe_cli_trains_an_image_data_net_as_the_jax_cli(
        images, tmp_path, capsys):
    d, root = images
    text = ENCODED_NET.replace(
        'type: "Data"', 'type: "ImageData"').replace(
        'data_param {{ source: "{db}" batch_size: 4 backend: LMDB }}',
        f'image_data_param {{{{ source: "{d / "list.txt"}" root_folder: '
        f'"{root}/" batch_size: 4 new_height: 20 new_width: 20 }}}}')
    ours, theirs = _cli_pair(tmp_path, capsys, text.format())
    _assert_tracks(ours, theirs)


def test_encoded_db_feed_equals_the_jax_feed(encoded_lmdb):
    text = ENCODED_NET.format(db=encoded_lmdb)
    for phase in ("TRAIN", "TEST"):
        feed = db.db_feed(load_net_prototxt(text).layer[0], Phase[phase],
                          seed=1, device="cpu", workers=2)
        jfeed = jdb.db_feed(jax_load_net(text).layer[0], JaxPhase[phase],
                            seed=1)
        for _ in range(3):
            got, want = next(feed), next(jfeed)
            for k in want:
                assert got[k].tobytes() == want[k].tobytes(), k
        feed.close()
