"""The port's ``classify`` (``Classifier``, ``Detector``), its CLIs
(``classify_cli``, ``detect_cli``), ``pycaffe_io`` and ``pycaffe_pb2``
against the JAX package's, on the CPU (``device="cpu"``,
``--device cpu``).

The net is tests/test_tools.py's deploy net (a strided convolution, an
InnerProduct of 3, Softmax) with a ReLU and an ACROSS_CHANNELS LRN after
the convolution, so that the forward on the card runs the inference
kernel; the weights are drawn by the port and read by both packages from
one ``.caffemodel``.  Probabilities agree within rtol 1e-5, atol 1e-6:

- ``Classifier.predict``, 10-crop and center-only, with no mean, a
  per-channel and a crop-sized mean, ``raw_scale``, ``input_scale`` and
  ``channel_swap`` (tests/test_tools.py:283-311, :354-382, :736-751);
- ``Detector.detect_windows`` with context padding, border-clipped
  windows, a vector mean and ``channel_swap`` (:334-353, :783-801);
- ``classify_cli`` on a directory of JPEGs and one of PNGs (every
  committed PNG fixture, colour and gray, 8- and 16-bit, palettes and
  Adam7), an ``.npy`` batch, ``--center_only``, both ``--mean_file``
  forms; ``detect_cli`` on a windows CSV (:699-733, :754-781).

On the CPU the JAX package reads images with PIL; the port reads PNG with
its own decoder, so ``load_image`` is held against the JAX one on every
PNG fixture too, and on the CMYK JPEG.  ``resize_image`` (PIL's mode "F"
resize), ``Transformer``, the blobproto and Datum helpers, and
``pycaffe_pb2`` messages (bytes, text, presence, enums) equal the JAX
module's.  ``RemoteClassifier`` and ``--server`` classify through the
port's HTTP shell as the JAX client does, and without ``device="cpu"``
and without a card nothing runs.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

from sparknet_tpu import classify as jax_classify
from sparknet_tpu import pycaffe_io as jax_io
from sparknet_tpu import pycaffe_pb2 as jax_pb2
from sparknet_tpu.tools import classify_cli as jax_classify_cli
from sparknet_tpu.tools import detect_cli as jax_detect_cli
from sparknet_tpu_torch import classify, pycaffe_io, pycaffe_pb2
from sparknet_tpu_torch.graph.net import Net
from sparknet_tpu_torch.proto import NetState, Phase, load_net_prototxt
from sparknet_tpu_torch.proto.caffemodel import save_caffemodel
from sparknet_tpu_torch.tools import classify_cli, detect_cli

from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
PNG_FIXTURES = (pathlib.Path(__file__).resolve().parent.parent
                / "sparknet_tpu_torch" / "data" / "png_fixtures")
DEPLOY_NET = """
name: "deploy"
input: "data"
input_shape { dim: 1 dim: 3 dim: 8 dim: 8 }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 6 kernel_size: 3 pad: 1 stride: 2
    weight_filler { type: "xavier" } bias_filler { type: "constant"
    value: 0.1 } } }
layer { name: "relu" type: "ReLU" bottom: "conv" top: "conv" }
layer { name: "norm" type: "LRN" bottom: "conv" top: "norm"
  lrn_param { local_size: 3 alpha: 0.01 beta: 0.75 } }
layer { name: "ip" type: "InnerProduct" bottom: "norm" top: "ip"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
layer { name: "prob" type: "Softmax" bottom: "ip" top: "prob" }
"""


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = tmp_path_factory.mktemp("classify")
    (d / "deploy.prototxt").write_text(DEPLOY_NET)
    net = Net(load_net_prototxt(DEPLOY_NET), NetState(Phase.TEST))
    params = net.init(torch.Generator().manual_seed(3), device="cpu")
    save_caffemodel(str(d / "w.caffemodel"), params)
    return str(d / "deploy.prototxt"), str(d / "w.caffemodel")


MEANS = {"none": None, "vector": np.array([0.1, 0.2, 0.3]).reshape(3, 1, 1),
         "crop": np.random.default_rng(4).uniform(0, 1, (3, 8, 8))
         .astype(np.float32)}


@pytest.mark.parametrize("mean", list(MEANS))
@pytest.mark.parametrize("opts", [
    {}, {"raw_scale": 255.0, "input_scale": 0.01},
    {"channel_swap": (2, 1, 0)}, {"image_dims": (8, 8)}])
def test_classifier_equals_jax(model, mean, opts):
    opts = {"image_dims": (10, 12), **opts, "mean": MEANS[mean]}
    rng = np.random.default_rng(1)
    imgs = [rng.uniform(size=(11, 13, 3)).astype(np.float32),
            rng.normal(size=(3, 10, 12)), rng.uniform(size=(9, 9, 3))]
    ours = classify.Classifier(*model, device="cpu", **opts)
    theirs = jax_classify.Classifier(*model, **opts)
    for oversample in (True, False):
        got = ours.predict(imgs, oversample_crops=oversample)
        want = theirs.predict(imgs, oversample_crops=oversample)
        assert got.shape == (3, 3)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)


def test_oversample_equals_jax():
    imgs = np.random.default_rng(2).normal(size=(2, 3, 11, 13))
    np.testing.assert_array_equal(classify.oversample(imgs, 8),
                                  jax_classify.oversample(imgs, 8))
    hwc = list(imgs.transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(pycaffe_io.oversample(hwc, (8, 9)),
                                  jax_io.oversample(hwc, (8, 9)))


@pytest.mark.parametrize("opts", [
    {"context_pad": 0}, {"context_pad": 2, "mean": MEANS["vector"]},
    {"context_pad": 3, "channel_swap": (2, 1, 0), "raw_scale": 2.0,
     "mean": MEANS["crop"]}])
def test_detector_equals_jax(model, opts):
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(3, 20, 24)).astype(np.float32)
    wins = [(0, 0, 10, 10), (5, 6, 19, 23), (0, 2, 19, 23), (12, 1, 14, 4)]
    got = classify.Detector(*model, device="cpu", **opts).detect_windows(
        [(img, wins), (img[:, ::-1], wins[:2])])
    want = jax_classify.Detector(*model, **opts).detect_windows(
        [(img, wins), (img[:, ::-1], wins[:2])])
    assert [d["window"] for d in got] == [d["window"] for d in want]
    np.testing.assert_allclose([d["prediction"] for d in got],
                               [np.asarray(d["prediction"]) for d in want],
                               rtol=RTOL, atol=ATOL)


def _image_dir(d: pathlib.Path, ext: str) -> pathlib.Path:
    out = d / f"imgs_{ext}"
    out.mkdir()
    if ext == "png":
        # the JAX Classifier reads an (H, W, C) image whose H is 1 or 3 as
        # (C, H, W): the 1x1 and 3x2 fixtures stay out
        manifest = json.loads((PNG_FIXTURES / "manifest.json").read_text())
        for name, e in manifest["images"].items():
            if name.endswith(".png") and e["height"] not in (1, 3):
                (out / name).write_bytes((PNG_FIXTURES / name).read_bytes())
    else:
        rng = np.random.default_rng(0)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (10 + i, 12, 3))
                            .astype(np.uint8)).save(str(out / f"im{i}.jpg"))
    return out


@pytest.mark.parametrize("ext", ["jpg", "png"])
@pytest.mark.parametrize("flags", [
    ["--images_dim", "8,8", "--center_only"],
    ["--images_dim", "10,10", "--mean_file", "{vector}"],
    ["--images_dim", "12,12", "--mean_file", "{crop}", "--channel_swap",
     "0,1,2", "--raw_scale", "1"]])
def test_classify_cli_equals_jax(model, tmp_path, ext, flags):
    np.save(tmp_path / "vector.npy", np.array([100., 110., 120.]))
    np.save(tmp_path / "crop.npy", MEANS["crop"] * 255)
    flags = [f.format(vector=tmp_path / "vector.npy",
                      crop=tmp_path / "crop.npy") for f in flags]
    src = _image_dir(tmp_path, ext)
    args = ["--model_def", model[0], "--pretrained_model", model[1],
            "--ext", ext] + flags
    with contextlib.redirect_stdout(io.StringIO()):
        assert classify_cli.main([str(src), str(tmp_path / "ours.npy"),
                                  "--device", "cpu"] + args) == 0
        assert jax_classify_cli.main([str(src), str(tmp_path / "theirs.npy")]
                                     + args) == 0
    got, want = np.load(tmp_path / "ours.npy"), np.load(
        tmp_path / "theirs.npy")
    assert got.shape == want.shape == (len(list(src.iterdir())), 3)
    assert len(got) >= (3 if ext == "jpg" else 30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_classify_cli_npy_and_one_image_equal_jax(model, tmp_path):
    batch = np.random.default_rng(5).uniform(size=(2, 10, 10, 3)).astype(
        np.float32)
    np.save(tmp_path / "batch.npy", batch)
    one = PNG_FIXTURES / "photo_375x500.png"
    for src in (tmp_path / "batch.npy", one):
        args = [str(src), "--model_def", model[0], "--pretrained_model",
                model[1], "--images_dim", "10,10"]
        with contextlib.redirect_stdout(io.StringIO()):
            assert classify_cli.main([args[0], str(tmp_path / "o.npy")]
                                     + args[1:] + ["--device", "cpu"]) == 0
            assert jax_classify_cli.main([args[0], str(tmp_path / "t.npy")]
                                         + args[1:]) == 0
        np.testing.assert_allclose(np.load(tmp_path / "o.npy"),
                                   np.load(tmp_path / "t.npy"), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("mean", [None, "vector", "image"])
def test_detect_cli_equals_jax(model, tmp_path, mean):
    rng = np.random.default_rng(2)
    jpg = tmp_path / "scene.jpg"
    Image.fromarray(rng.integers(0, 256, (24, 30, 3)).astype(np.uint8)).save(
        str(jpg))
    png = PNG_FIXTURES / "pil_rgb.png"
    (tmp_path / "windows.csv").write_text(
        "filename,ymin,xmin,ymax,xmax\n"
        f"{jpg},0,0,12,12\n{jpg},8,8,24,30\n{png},2,3,30,50\n"
        f"{jpg},-2,-3,6,7\n")
    extra = []
    if mean == "vector":
        np.save(tmp_path / "m.npy", np.array([90., 100., 110.]))
        extra = ["--mean_file", str(tmp_path / "m.npy")]
    elif mean == "image":
        np.save(tmp_path / "m.npy", rng.uniform(80, 120, (3, 8, 8)))
        extra = ["--mean_file", str(tmp_path / "m.npy")]
    args = ["--model_def", model[0], "--pretrained_model", model[1],
            "--context_pad", "2"] + extra
    with contextlib.redirect_stdout(io.StringIO()):
        assert detect_cli.main([str(tmp_path / "windows.csv"),
                                str(tmp_path / "ours.csv"), "--device",
                                "cpu"] + args) == 0
        assert jax_detect_cli.main([str(tmp_path / "windows.csv"),
                                    str(tmp_path / "theirs.csv")] + args) == 0
    ours = list(csv.reader(open(tmp_path / "ours.csv")))
    theirs = list(csv.reader(open(tmp_path / "theirs.csv")))
    assert ours[0] == theirs[0] == ["filename", "ymin", "xmin", "ymax",
                                    "xmax", "class0", "class1", "class2"]
    assert [r[:5] for r in ours] == [r[:5] for r in theirs]
    np.testing.assert_allclose(
        [[float(v) for v in r[5:]] for r in ours[1:]],
        [[float(v) for v in r[5:]] for r in theirs[1:]], rtol=RTOL, atol=ATOL)


def _images() -> list[pathlib.Path]:
    manifest = json.loads((PNG_FIXTURES / "manifest.json").read_text())
    return [PNG_FIXTURES / n for n in sorted(manifest["images"])]


@pytest.mark.parametrize("path", _images(), ids=lambda p: p.name)
def test_load_image_equals_jax(path):
    for color in (True, False):
        got = pycaffe_io.load_image(str(path), color, device="cpu")
        want = jax_io.load_image(str(path), color)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape
        assert got.tobytes() == want.tobytes(), color


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_resize_image_equals_jax(order):
    im = np.random.default_rng(order).uniform(size=(13, 17, 3)).astype(
        np.float32)
    for dims in ((8, 8), (27, 31), (1, 5), (13, 17)):
        got = pycaffe_io.resize_image(im, dims, order)
        want = jax_io.resize_image(im, dims, order)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_transformer_equals_jax():
    rng = np.random.default_rng(7)
    img = rng.uniform(size=(12, 10, 3)).astype(np.float32)
    mu = rng.uniform(size=3).astype(np.float32)
    ts = []
    for mod in (pycaffe_io, jax_io):
        t = mod.Transformer({"data": (1, 3, 8, 8)})
        t.set_transpose("data", (2, 0, 1))
        t.set_mean("data", mu)
        t.set_raw_scale("data", 255)
        t.set_channel_swap("data", (2, 1, 0))
        t.set_input_scale("data", 0.5)
        ts.append(t)
    got, want = (t.preprocess("data", img) for t in ts)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(ts[0].deprocess("data", got),
                               ts[1].deprocess("data", want), rtol=1e-5)
    for t in (pycaffe_io.Transformer({"data": (1, 3, 8, 8)}),):
        with pytest.raises(ValueError, match="Mean shape"):
            t.set_mean("data", np.zeros((3, 4, 4)))
        with pytest.raises(ValueError, match="Channel swap"):
            t.set_channel_swap("data", (1, 0))
        with pytest.raises(ValueError, match="not one of the net inputs"):
            t.set_raw_scale("label", 1.0)


def test_blobproto_and_datum_helpers_equal_jax():
    rng = np.random.default_rng(8)
    arr = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    diff = rng.normal(size=arr.shape).astype(np.float32)
    ours = pycaffe_io.array_to_blobproto(arr, diff)
    theirs = jax_io.array_to_blobproto(arr, diff)
    assert ours.SerializeToString() == theirs.SerializeToString()
    np.testing.assert_array_equal(pycaffe_io.blobproto_to_array(ours), arr)
    np.testing.assert_array_equal(
        pycaffe_io.blobproto_to_array(ours, return_diff=True), diff)
    vec = pycaffe_io.arraylist_to_blobprotovecor_str([arr, diff[0]])
    assert vec == jax_io.arraylist_to_blobprotovecor_str([arr, diff[0]])
    back = pycaffe_io.blobprotovector_str_to_arraylist(vec)
    np.testing.assert_array_equal(back[0], arr)
    np.testing.assert_array_equal(back[1], diff[0])
    for img in (rng.integers(0, 256, (3, 4, 5)).astype(np.uint8),
                rng.normal(size=(1, 2, 3))):
        d = pycaffe_io.array_to_datum(img, 7)
        assert d.SerializeToString() == \
            jax_io.array_to_datum(img, 7).SerializeToString()
        parsed = pycaffe_pb2.Datum()
        parsed.ParseFromString(d.SerializeToString())
        np.testing.assert_array_equal(pycaffe_io.datum_to_array(parsed),
                                      jax_io.datum_to_array(parsed))
        assert parsed.label == 7
    with pytest.raises(ValueError, match="array shape"):
        pycaffe_io.array_to_datum(np.zeros((2, 2)))


def _build(pb2):
    """The same messages built through one pb2 module's API."""
    blob = pb2.BlobProto()
    blob.shape.dim.extend([2, 3])
    blob.data.extend([float(i) / 3 for i in range(6)])
    blob.data.append(9.5)
    net = pb2.NetParameter()
    net.name = "n"
    net.input.append("data")
    lp = net.layer.add()
    lp.name, lp.type = "conv", "Convolution"
    lp.bottom.append("data")
    lp.top.append("conv")
    rule = lp.include.add()
    rule.phase = pb2.TEST
    lp.convolution_param.num_output = 4
    lp.convolution_param.kernel_size = 3
    sp = pb2.SolverParameter()
    sp.base_lr = 0.01
    sp.lr_policy = "step"
    sp.solver_mode = 0
    sp.test_iter.extend([5, 6])
    sp.stepvalue.append(100)
    datum = pb2.Datum()
    datum.channels, datum.height, datum.width = 1, 2, 2
    datum.data = bytes([1, 2, 3, 4])
    datum.label = 3
    return {"blob": blob, "net": net, "solver": sp, "datum": datum}


def test_pb2_messages_serialize_as_jax_ones_do():
    ours, theirs = _build(pycaffe_pb2), _build(jax_pb2)
    for key in ours:
        assert ours[key].SerializeToString() == \
            theirs[key].SerializeToString(), key
        try:
            text = str(theirs[key])
        except TypeError:   # the text form of packed numeric chunks
            with pytest.raises(TypeError):
                str(ours[key])
        else:
            assert str(ours[key]) == text, key
        copy = type(ours[key])()
        copy.ParseFromString(theirs[key].SerializeToString())
        assert copy.SerializeToString() == ours[key].SerializeToString()
    net = ours["net"]
    assert net.layer[0].include[0].phase == pycaffe_pb2.TEST
    assert net.layer[0].convolution_param.kernel_size == 3
    assert len(ours["blob"].data) == 7 and ours["blob"].data[6] == 9.5
    fresh = pycaffe_pb2.BlobProto()
    assert fresh.shape.dim == [] and not fresh.HasField("shape")
    fresh.shape.dim.append(4)
    assert fresh.HasField("shape")
    with pytest.raises(AttributeError, match="no field"):
        fresh.nonsense  # noqa: B018
    with pytest.raises(ValueError, match="unknown enum"):
        ours["solver"].solver_mode = "TPU"


def test_remote_classifier_and_server_raise_naming_a11(tmp_path):
    """They no longer raise: ``RemoteClassifier`` and ``classify_cli
    --server`` classify through the port's HTTP shell (served from this
    process on the CPU), equal within 1e-5 to the JAX package's
    ``RemoteClassifier`` against the same server."""
    import threading

    from sparknet_tpu_torch.parallel import serving
    from sparknet_tpu_torch.tools import serve
    cfg = serving.ServeConfig(batch_shapes=(1, 4, 16), dtype="f32",
                              max_delay_ms=5.0)
    house = serving.ModelHouse(cfg, device="cpu")
    house.load("lenet")
    engine = serving.InferenceEngine(house)
    # tools/serve.py's own server: a 10-crop burst overflows the default
    # listen backlog of 5, and the kernel resets the connections
    httpd = serve.Server(("127.0.0.1", 0),
                         serve.make_handler(engine, house))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    try:
        imgs = [np.random.default_rng(i).uniform(size=(32, 32)).astype(
            np.float32) for i in range(2)]
        ours = classify.RemoteClassifier(
            url, "lenet", image_dims=(32, 32)).predict(imgs)
        theirs = jax_classify.RemoteClassifier(
            url, "lenet", image_dims=(32, 32)).predict(imgs)
        assert ours.shape == (2, 10)
        np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)
        np.save(tmp_path / "b.npy", np.stack(imgs)[..., None])
        assert classify_cli.main(
            [str(tmp_path / "b.npy"), str(tmp_path / "o.npy"), "--server",
             url, "--model", "lenet", "--images_dim", "32,32",
             "--channel_swap", "", "--raw_scale", "1"]) == 0
        np.testing.assert_allclose(np.load(tmp_path / "o.npy"), ours,
                                   rtol=RTOL, atol=ATOL)
        with pytest.raises(SystemExit):
            classify_cli.main([str(tmp_path / "b.npy"),
                               str(tmp_path / "o.npy"), "--server", url])
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()


def test_nothing_leaves_the_card_unasked(model, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        classify.Classifier(*model)
    with pytest.raises(RuntimeError, match="CUDA"):
        pycaffe_io.load_image(str(PNG_FIXTURES / "photo_375x500.png"))
    np.save(tmp_path / "b.npy", np.zeros((1, 8, 8, 3), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        classify_cli.main([str(tmp_path / "b.npy"), str(tmp_path / "o.npy"),
                           "--model_def", model[0]])
