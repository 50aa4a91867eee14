"""The port's Data, MemoryData and DummyData layers, its ``db_feed`` and
its fillers against the JAX package's, on the CPU.

- ``db_feed`` over an LMDB and a LevelDB of 3x8x8 uint8 Datums, in TRAIN
  and TEST, with crop, mirror, ``mean_file``, ``mean_value`` and
  ``scale``: the first five batches equal the JAX ``db_feed``'s exactly
  (``assert_array_equal``), labels included, for the same seed.  The JAX
  feed parses clean batches in its native library where that is built;
  uint8 -> f32, the crop copy and the one f32 mean subtraction give the
  same bits either way.  The decode-pool width does not change the
  batches.
- A corrupt record in the DB: with a budget of one, both packages skip it
  and pull the same replacement; with none, both raise
  ``DataCorruptionError`` naming its key.  The port's fault seam
  (``db.corrupt_record``) goes through the same quarantine.  A mean file
  of the wrong shape raises.
- Net shapes of Data (crop applied), MemoryData and DummyData (``shape``
  list and legacy num/channels/height/width) equal the JAX
  ``Net.blob_shapes``; constant DummyData tops equal JAX's exactly and
  random ones are held by shape, mean and std (the generators differ);
  DummyData nets train and test in the port's Solver.
- Fillers: ``uniform``, ``msra``, ``positive_unitball`` by their defining
  statistics; ``bilinear`` (deterministic) exactly against JAX.
- A standalone Data-layer net (tests/test_db.py:117-151's, at unit
  scale) through both Solvers from one ``.caffemodel`` for 10 steps:
  losses within rtol 2e-4, atol 2e-5 (tests/test_torch_solver.py's
  bound).
- Record shards converted from the LMDB feed the JAX LMDB feed's
  batches through ``db_feed`` (``backend: RECORDS`` or a ``*.rec``
  source); HDF5Data builds from its first file and feeds the JAX
  ``hdf5_feed``'s batches, and HDF5Output builds; ImageData and
  WindowData without a ``source`` raise as the JAX package's do (their
  feeds: tests/test_torch_image_data.py).
"""

from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch

from sparknet_tpu.data import db as jdb
from sparknet_tpu.graph import Net as JaxNet
from sparknet_tpu.ops.fillers import fill as jax_fill
from sparknet_tpu.proto import FillerParameter as JaxFiller
from sparknet_tpu.proto import NetState as JaxNetState
from sparknet_tpu.proto import caffemodel as jax_cm
from sparknet_tpu.proto import load_net_prototxt as jax_load_net
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_sp
from sparknet_tpu.proto.caffe_pb import Phase as JaxPhase
from sparknet_tpu.solvers import Solver as JaxSolver
from sparknet_tpu_torch.data import db
from sparknet_tpu_torch.data.integrity import (DataCorruptionError,
                                               Quarantine, QuarantinePolicy)
from sparknet_tpu_torch.data.leveldb_io import write_leveldb
from sparknet_tpu_torch.data.lmdb_io import write_lmdb
from sparknet_tpu_torch.data.pipeline import feed_workers
from sparknet_tpu_torch.graph.net import Net
from sparknet_tpu_torch.ops.fillers import fill
from sparknet_tpu_torch.proto import (FillerParameter, NetState, Phase,
                                      load_net_prototxt,
                                      load_solver_prototxt_with_net,
                                      save_mean_binaryproto)
from sparknet_tpu_torch.solvers import Solver

N_RECORDS, SHAPE = 20, (3, 8, 8)


def _write_db(path, backend, n=N_RECORDS, corrupt_at=None, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, size=(n,) + SHAPE).astype(np.uint8)
    labels = rng.integers(0, 10, size=n)
    items = [(b"%08d" % i, db.array_to_datum(imgs[i], int(labels[i])))
             for i in range(n)]
    if corrupt_at is not None:
        key, val = items[corrupt_at]
        items[corrupt_at] = (key, val[:-5])
    (write_lmdb if backend == "LMDB" else write_leveldb)(str(path), items)
    return str(path), imgs, labels


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dbs")
    out = {b: _write_db(d / b.lower(), b)[0] for b in ("LMDB", "LEVELDB")}
    mean = np.random.default_rng(1).uniform(0, 255, SHAPE).astype(np.float32)
    save_mean_binaryproto(str(d / "mean.binaryproto"), mean)
    out["mean"] = str(d / "mean.binaryproto")
    return out


TRANSFORMS = {
    "plain": "",
    "crop_mirror_mean_file": "crop_size: 6 mirror: true mean_file: '{mean}'",
    "crop_mean_value_scale": ("crop_size: 5 mean_value: 10 mean_value: 20 "
                              "mean_value: 30 scale: 0.5"),
    "mirror_mean_file": "mirror: true mean_file: '{mean}'",
    "mirror_scale": "mirror: true scale: 0.00390625",
    "mean_value_scale": "mean_value: 10 scale: 0.5",
    "scale": "scale: 0.00390625",
}


def _data_layer_txt(source, backend, transform="", batch=8, name="d"):
    return (f'layer {{ name: "{name}" type: "Data" top: "data" '
            f'top: "label" transform_param {{ {transform} }} data_param {{ '
            f'source: "{source}" batch_size: {batch} backend: {backend} '
            f'}} }}\n')


def _layers(txt):
    return load_net_prototxt(txt).layer[0], jax_load_net(txt).layer[0]


def _take(feed, n):
    return [{k: np.array(v) for k, v in next(feed).items()}
            for _ in range(n)]


def _assert_batches_equal(ours, theirs):
    for i, (b, jb) in enumerate(zip(ours, theirs)):
        assert set(b) == set(jb) == {"data", "label"}
        for k in b:
            assert b[k].dtype == jb[k].dtype == np.float32, (i, k)
            np.testing.assert_array_equal(b[k], jb[k], err_msg=f"{i} {k}")


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("backend", ["LMDB", "LEVELDB"])
@pytest.mark.parametrize("transform", TRANSFORMS)
def test_db_feed_equals_jax(dbs, backend, phase, transform):
    txt = _data_layer_txt(dbs[backend], backend,
                          TRANSFORMS[transform].format(mean=dbs["mean"]))
    lp, jlp = _layers(txt)
    feed = db.db_feed(lp, Phase[phase], seed=5)
    jfeed = jdb.db_feed(jlp, JaxPhase[phase], seed=5)
    ours, theirs = _take(feed, 5), _take(jfeed, 5)
    feed.close()
    jfeed.close()
    _assert_batches_equal(ours, theirs)
    if "crop" in transform:
        assert ours[0]["data"].shape[-1] in (5, 6)


def test_db_feed_workers_keep_the_batches(dbs, monkeypatch):
    """The stream is the same whatever the pool's width, and the knob's
    0 (the JAX package's serial path) takes one thread."""
    txt = _data_layer_txt(dbs["LMDB"], "LMDB",
                          TRANSFORMS["crop_mirror_mean_file"].format(
                              mean=dbs["mean"]))
    lp, _ = _layers(txt)
    runs = []
    for kw in (dict(workers=1), dict(workers=4), {}):
        feed = db.db_feed(lp, Phase.TRAIN, seed=2, **kw)
        runs.append(_take(feed, 4))
        feed.close()
        monkeypatch.setenv("SPARKNET_FEED_WORKERS", "0")
    _assert_batches_equal(runs[0], runs[1])
    _assert_batches_equal(runs[0], runs[2])
    assert feed_workers() == 1
    monkeypatch.delenv("SPARKNET_FEED_WORKERS")
    assert feed_workers(default=5) == 5   # the JAX signature's default
    monkeypatch.setenv("SPARKNET_FEED_WORKERS", "-1")
    with pytest.raises(ValueError, match="SPARKNET_FEED_WORKERS"):
        feed_workers()


def test_corrupt_record_quarantined_like_jax(tmp_path):
    path, _, _ = _write_db(tmp_path / "bad", "LMDB", corrupt_at=3)
    lp, jlp = _layers(_data_layer_txt(path, "LMDB", batch=4))
    q = Quarantine(QuarantinePolicy(max_records=1), source=path)
    from sparknet_tpu.data.integrity import Quarantine as JQ
    from sparknet_tpu.data.integrity import QuarantinePolicy as JQP
    jq = JQ(JQP(max_records=1), source=path)
    feed = db.db_feed(lp, Phase.TEST, quarantine=q)
    jfeed = jdb.db_feed(jlp, JaxPhase.TEST, quarantine=jq)
    _assert_batches_equal(_take(feed, 3), _take(jfeed, 3))
    feed.close()
    jfeed.close()
    assert q.report()["examples"][0]["key"] == repr(b"00000003")
    assert q.report() == jq.report()
    # zero tolerance, the default: the first bad record raises
    feed = db.db_feed(lp, Phase.TEST)
    with pytest.raises(DataCorruptionError, match="00000003"):
        next(feed)


def test_fault_seam_goes_through_the_quarantine(dbs, monkeypatch):
    lp, _ = _layers(_data_layer_txt(dbs["LMDB"], "LMDB", batch=4))
    clean = _take(db.db_feed(lp, Phase.TEST, workers=1), 2)
    monkeypatch.setattr(db, "corrupt_record",
                        lambda seq, val: val[:-1] if seq == 2 else None)
    q = Quarantine(QuarantinePolicy(max_records=1))
    feed = db.db_feed(lp, Phase.TEST, quarantine=q)
    first = next(feed)
    feed.close()
    # record 2 skipped, record 4 pulled in its place
    want = np.concatenate([clean[0]["label"][[0, 1, 3]],
                           clean[1]["label"][:1]])
    np.testing.assert_array_equal(first["label"], want)
    assert q.total_bad == 1


def test_mean_file_of_the_wrong_shape_raises(dbs, tmp_path):
    bad = str(tmp_path / "bad_mean.binaryproto")
    save_mean_binaryproto(bad, np.zeros((3, 9, 9), np.float32))
    lp, _ = _layers(_data_layer_txt(dbs["LMDB"], "LMDB",
                                    f"mean_file: '{bad}'"))
    with pytest.raises(ValueError, match="does not fit"):
        next(db.db_feed(lp, Phase.TEST))


def test_records_and_unknown_backends(dbs, tmp_path):
    """Record shards converted from the LMDB (a ``*.rec`` file under an
    LMDB backend, and a directory under ``backend: RECORDS``) feed the
    JAX LMDB feed's batches, and their Data layer the LMDB's shapes; an
    unknown backend still raises, and ``open_db``, whose readers have a
    Datum cursor, names ``RECORDS`` unknown too."""
    from sparknet_tpu_torch.data.records import convert_to_shards
    with db.open_db(dbs["LMDB"], "LMDB") as r:
        recs = [(img.astype(np.uint8), label) for img, label in
                (db.datum_to_array(v) for _, v in r.items())]
    out = convert_to_shards(iter(recs), str(tmp_path / "s"))
    tf = TRANSFORMS["crop_mirror_mean_file"].format(mean=dbs["mean"])
    _, jlp = _layers(_data_layer_txt(dbs["LMDB"], "LMDB", tf))
    want = _take(jdb.db_feed(jlp, JaxPhase.TRAIN, seed=3, workers=0), 4)
    for source, backend in ((out["shards"][0], "LMDB"),
                            (str(tmp_path / "s"), "RECORDS")):
        txt = _data_layer_txt(source, backend, tf)
        lp, _ = _layers(txt)
        feed = db.db_feed(lp, Phase.TRAIN, seed=3)
        _assert_batches_equal(_take(feed, 4), want)
        feed.close()
        assert Net(load_net_prototxt(txt), NetState(Phase.TRAIN)) \
            .blob_shapes["data"] == (8, 3, 6, 6)
    for backend in ("ROCKSDB", "RECORDS"):
        with pytest.raises(ValueError, match="unknown DB backend"):
            db.open_db(str(tmp_path), backend)


SHAPES_NET = """
layer {{ name: "m" type: "MemoryData" top: "mdata" top: "mlabel"
  memory_data_param {{ batch_size: 5 channels: 2 height: 3 width: 4 }} }}
layer {{ name: "dd" type: "DummyData" top: "a" top: "b"
  dummy_data_param {{ shape {{ dim: 2 dim: 3 }} shape {{ dim: 2 }}
    data_filler {{ type: "constant" value: 1.5 }}
    data_filler {{ type: "constant" value: -2 }} }} }}
layer {{ name: "dl" type: "DummyData" top: "c" top: "e"
  dummy_data_param {{ num: 2 num: 3 channels: 4 height: 5 width: 6
    data_filler {{ type: "constant" value: 0.25 }} }} }}
"""


def test_data_layer_shapes_equal_jax(dbs):
    txt = (_data_layer_txt(dbs["LMDB"], "LMDB", "crop_size: 6", batch=4)
           + SHAPES_NET.format())
    for phase in ("TRAIN", "TEST"):
        net = Net(load_net_prototxt(txt), NetState(Phase[phase]))
        jnet = JaxNet(jax_load_net(txt), JaxNetState(JaxPhase[phase]))
        assert net.blob_shapes == jnet.blob_shapes
        assert net.input_blobs == dict(jnet.input_blobs)
    assert net.blob_shapes["data"] == (4, 3, 6, 6)
    assert net.blob_shapes["e"] == (3, 4, 5, 6)


def test_constant_dummy_data_equals_jax():
    txt = SHAPES_NET.format().split('layer { name: "dd"', 1)[1]
    txt = 'layer { name: "dd"' + txt
    net = Net(load_net_prototxt(txt), NetState(Phase.TRAIN))
    jnet = JaxNet(jax_load_net(txt), JaxNetState(JaxPhase.TRAIN))
    out = net.apply({}, {}, train=True)
    jout = jnet.apply({}, {}, train=True).blobs
    assert set(out) == set(jout) == {"a", "b", "c", "e"}
    for k in out:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))


RANDOM_DUMMY = """
layer { name: "dd" type: "DummyData" top: "g" top: "u"
  dummy_data_param { shape { dim: 100 dim: 200 } shape { dim: 50 dim: 400 }
    data_filler { type: "gaussian" mean: 2 std: 3 }
    data_filler { type: "uniform" min: -1 max: 3 } } }
"""


def test_random_dummy_data_by_statistics():
    net = Net(load_net_prototxt(RANDOM_DUMMY), NetState(Phase.TRAIN))
    jnet = JaxNet(jax_load_net(RANDOM_DUMMY), JaxNetState(JaxPhase.TRAIN))
    out = net.apply({}, {}, train=True,
                    generator=torch.Generator().manual_seed(0))
    jout = jnet.apply({}, {}, train=True, rng=jax.random.PRNGKey(0)).blobs
    for k, (mean, std) in {"g": (2.0, 3.0),
                           "u": (1.0, 4.0 / math.sqrt(12))}.items():
        for arr in (out[k].numpy(), np.asarray(jout[k])):
            assert arr.shape == net.blob_shapes[k]
            assert abs(arr.mean() - mean) < 0.05 * std
            assert abs(arr.std() - std) < 0.03 * std
    assert out["u"].min() >= -1 and out["u"].max() < 3
    with pytest.raises(ValueError, match="torch.Generator"):
        net.apply({}, {}, train=True)


def _filler(**kw) -> FillerParameter:
    return FillerParameter(**kw)


def test_uniform_and_msra_fillers_by_statistics():
    gen = torch.Generator().manual_seed(0)
    u = fill(gen, _filler(type="uniform", min=-2.0, max=5.0), (200, 100))
    assert u.min() >= -2 and u.max() < 5
    assert abs(float(u.mean()) - 1.5) < 0.05
    assert abs(float(u.var()) - 49 / 12) < 0.1
    for norm, n in (("FAN_IN", 32 * 9), ("FAN_OUT", 64 * 9),
                    ("AVERAGE", (32 * 9 + 64 * 9) / 2)):
        w = fill(gen, _filler(type="msra", variance_norm=norm),
                 (64, 32, 3, 3))
        assert abs(float(w.mean())) < 0.01 * math.sqrt(2 / n) * 10
        assert abs(float(w.std()) / math.sqrt(2 / n) - 1) < 0.03, norm


def test_positive_unitball_filler():
    w = fill(torch.Generator().manual_seed(1),
             _filler(type="positive_unitball"), (20, 3, 4, 4))
    assert w.shape == (20, 3, 4, 4) and bool((w >= 0).all())
    np.testing.assert_allclose(w.reshape(20, -1).sum(1).numpy(), 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("shape", [(3, 1, 4, 4), (2, 2, 5, 5), (1, 1, 3, 6)])
def test_bilinear_filler_equals_jax(shape):
    got = fill(torch.Generator(), _filler(type="bilinear"), shape)
    want = jax_fill(jax.random.PRNGKey(0), JaxFiller(type="bilinear"), shape)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unknown_filler_raises():
    with pytest.raises(ValueError, match="unknown filler"):
        fill(torch.Generator(), _filler(type="sparse_gaussian"), (2, 2))


DUMMY_TRAIN_NET = """
layer { name: "data" type: "DummyData" top: "data" top: "label"
  dummy_data_param { shape { dim: 4 dim: 3 } shape { dim: 4 }
    data_filler { type: "gaussian" std: 1 } data_filler { type: "constant" value: 1 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 2 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" }
"""


def test_dummy_data_net_trains_and_tests_in_the_solver():
    sp = load_solver_prototxt_with_net(
        'base_lr: 0.1\nlr_policy: "fixed"\ntest_iter: 2\n',
        load_net_prototxt(DUMMY_TRAIN_NET))
    solver = Solver(sp, device="cpu")
    assert not solver.train_net.input_blobs
    losses = [solver.step(1) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    scores = solver.test(2)
    assert set(scores) == {"loss"} and np.isfinite(scores["loss"])


def test_data_layer_net_tracks_the_jax_solver(dbs, tmp_path):
    txt = (_data_layer_txt(dbs["LMDB"], "LMDB",
                           "crop_size: 6 mirror: true scale: 0.00390625",
                           batch=4, name="cifar")
           + """
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }
""")
    solver_txt = 'base_lr: 0.1\nmomentum: 0.9\nlr_policy: "fixed"\n'
    jsolver = JaxSolver(jax_sp(solver_txt, jax_load_net(txt)), seed=0)
    solver = Solver(load_solver_prototxt_with_net(
        solver_txt, load_net_prototxt(txt)), seed=3, device="cpu")
    path = str(tmp_path / "init.caffemodel")
    jax_cm.save_caffemodel(path, {k: [np.asarray(b) for b in v] for k, v in
                                  jax.device_get(jsolver.params).items()},
                           jsolver.sp.net_param)
    solver.load_weights(path)
    lp, jlp = load_net_prototxt(txt).layer[0], jax_load_net(txt).layer[0]
    solver.set_train_data(db.db_feed(lp, Phase.TRAIN, seed=0))
    jsolver.set_train_data(jdb.db_feed(jlp, JaxPhase.TRAIN, seed=0))
    ours = [solver.step(1) for _ in range(10)]
    theirs = [jsolver.step(1) for _ in range(10)]
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-5)
    assert ours[-1] != ours[0]


@pytest.mark.parametrize("kind", ["ImageData", "WindowData"])
def test_image_layers_without_a_source_raise_as_jax(kind):
    txt = f'layer {{ name: "x" type: "{kind}" top: "data" }}'
    with pytest.raises(ValueError, match="missing source") as ours:
        Net(load_net_prototxt(txt), NetState(Phase.TRAIN))
    with pytest.raises(ValueError, match="missing source") as theirs:
        JaxNet(jax_load_net(txt), JaxNetState(JaxPhase.TRAIN))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kind", ["HDF5Data", "HDF5Output"])
def test_hdf5_data_layers_build_and_feed(tmp_path, kind):
    """HDF5Data takes its shapes from the first listed file and its feed
    gives the JAX feed's batches; HDF5Output consumes its bottom and
    gives no top; both nets' blob shapes equal the JAX package's."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(4)
    paths = []
    for i in range(2):
        path = tmp_path / f"part{i}.h5"
        with h5py.File(path, "w") as f:
            f["data"] = rng.normal(size=(6, 2, 3, 3)).astype(np.float32)
            f["label"] = rng.integers(0, 3, size=6).astype(np.float64)
        paths.append(path.name)
    (tmp_path / "list.txt").write_text("\n".join(paths) + "\n")
    txt = (f'layer {{ name: "h" type: "HDF5Data" top: "data" top: "label" '
           f'hdf5_data_param {{ source: "{tmp_path / "list.txt"}" '
           f'batch_size: 4 shuffle: true }} }}\n')
    if kind == "HDF5Output":
        txt += ('layer { name: "out" type: "HDF5Output" bottom: "data" '
                'bottom: "label" hdf5_output_param { file_name: "o.h5" } }\n')
    net = Net(load_net_prototxt(txt), NetState(Phase.TRAIN))
    jnet = JaxNet(jax_load_net(txt), JaxNetState(JaxPhase.TRAIN))
    assert net.blob_shapes == jnet.blob_shapes
    assert net.blob_shapes["data"] == (4, 2, 3, 3)
    if kind == "HDF5Output":
        assert net.apply(net.init(torch.Generator().manual_seed(0),
                                  device="cpu"),
                         {"data": torch.zeros(4, 2, 3, 3),
                          "label": torch.zeros(4)}) is not None
        return
    lp, jlp = _layers(txt)
    ours = _take(db.feed_for_layer(lp, Phase.TRAIN, seed=5), 5)
    theirs = _take(jdb.feed_for_layer(jlp, JaxPhase.TRAIN, seed=5), 5)
    _assert_batches_equal(ours, theirs)
