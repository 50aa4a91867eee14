"""The port's own HDF5 reader and writer (``data/hdf5_format.py``) and
its HDF5 data and snapshot paths (``data/hdf5.py``) against h5py and the
JAX package, on the CPU.  Every case that needs h5py skips without it.

- The reader equals h5py bit for bit (values, dtype, shape, attributes)
  over a matrix of files h5py writes here: i1-i8, u1-u8, f4 and f8 of
  both byte orders; rank 0 to 4 and an empty dataset; compact,
  contiguous and chunked layouts with edge chunks and missing chunks
  read as the fill value; gzip at levels 1 and 9, shuffle and fletcher32
  alone and together, a chunk written with its deflate bit masked;
  nested groups and groups of 9 and 300 members; attributes of numbers
  and strings; fixed-length and variable-length strings.  A flipped byte
  in a fletcher32 chunk is caught.
- Refused by name (ROADMAP A6, HDF5): ``libver="latest"`` (superblock
  v3) and a ``track_order`` group (a version-2 object header, link
  messages); a file that is no HDF5 is a format error.
- The writer's files read back through h5py, the port's reader and the
  JAX ``load_model_hdf5``/``load_state_hdf5`` bit for bit, a group of
  300 members included.
- ``load_hdf5_blobs``, ``save_hdf5_blobs`` and ``hdf5_feed`` (shuffled
  and not) equal the JAX package's.
- ``snapshot_format: HDF5`` both ways: the JAX Solver's
  ``.solverstate.h5`` restores into the port's Solver and the port's
  into the JAX Solver (params, history and iter bit for bit), and ten
  further steps of each pair track at tests/test_torch_solver.py's bound
  (rtol 2e-4, atol 2e-5); ``load_weights`` reads the JAX
  ``.caffemodel.h5``.  cifar10_quick's layers are in sorted order, so
  the JAX Solver's sorted history (ROADMAP C) is the net order here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sparknet_tpu.data import hdf5 as jhdf5
from sparknet_tpu.models import cifar10_quick as jax_quick
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_sp
from sparknet_tpu.solvers import Solver as JaxSolver
from sparknet_tpu_torch.data import hdf5, hdf5_format
from sparknet_tpu_torch.models import cifar10_quick
from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
from sparknet_tpu_torch.solvers import Solver
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

h5py = pytest.importorskip("h5py")

RTOL, ATOL = 2e-4, 2e-5
TYPES = ["i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f4", "f8",
         ">i2", ">i4", ">i8", ">u4", ">f4", ">f8"]


def _write_matrix(path) -> list[str]:
    rng = np.random.default_rng(0)
    names = []

    def put(name, **kw):
        f.create_dataset(name, **kw)
        names.append(name)

    with h5py.File(path, "w") as f:
        for t in TYPES:
            put("type_" + t.replace(">", "be"),
                data=(rng.normal(size=(4, 5)) * 60).astype(t))
        put("rank0", data=np.float64(2.5))
        put("rank1", data=rng.normal(size=7).astype("f4"))
        put("rank3", data=rng.normal(size=(2, 3, 4)).astype("f4"))
        put("rank4", data=rng.normal(size=(2, 3, 4, 5)).astype("f8"))
        put("empty", shape=(0, 3), dtype="f4")
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT32,
                        h5py.h5s.create_simple((6,)), dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, np.arange(6, dtype="i4"))
        names.append("compact")
        put("chunk_edges", data=rng.normal(size=(37, 23)).astype("f4"),
            chunks=(10, 7))
        put("chunk_rank3", data=rng.integers(0, 9, size=(5, 6, 7)),
            chunks=(2, 4, 3))
        put("gzip1", data=rng.normal(size=(100, 4)).astype("f4"),
            compression="gzip", compression_opts=1)
        put("gzip9_shuffle", data=rng.integers(0, 100, size=(50, 30)),
            compression="gzip", compression_opts=9, shuffle=True,
            chunks=(16, 16))
        put("shuffle_only", data=rng.normal(size=(33,)).astype(">f8"),
            shuffle=True, chunks=(8,))
        put("fletcher32", data=rng.normal(size=(40,)).astype("f8"),
            fletcher32=True, chunks=(15,))
        put("all_filters", data=rng.normal(size=(33, 9)).astype("f4"),
            fletcher32=True, shuffle=True, compression="gzip",
            chunks=(8, 4))
        put("missing_chunks", shape=(20,), dtype="f4", chunks=(5,),
            fillvalue=7.0)
        f["missing_chunks"][0:5] = 1.0
        f["missing_chunks"][15:17] = 2.0
        ds = f.create_dataset("masked_chunk", shape=(8,), dtype="i4",
                              chunks=(4,), compression="gzip")
        ds[0:4] = np.arange(4)
        # chunk 1 stored raw, its deflate bit set in the filter mask
        ds.id.write_direct_chunk((4,), np.arange(10, 14, dtype="i4")
                                 .tobytes(), filter_mask=1)
        names.append("masked_chunk")
        put("vlen_string", data="a solver's learned_net")
        put("fixed_string", data=np.bytes_(b"fixed-length"))
        put("vlen_strings", data=np.array(["a", "bb", "ccc"],
                                          dtype=h5py.string_dtype()))
        g9 = f.create_group("g9")
        for i in range(9):
            g9.create_dataset(f"d{i}", data=np.full(i + 1, i, "f4"))
        g300 = f.create_group("g300")
        for i in range(300):
            g300.create_dataset(f"x{i:03d}", data=np.int64(i))
        f.create_group("a/b/c").create_dataset("deep", data=np.eye(3))
        f.attrs["int_attr"] = 5
        f.attrs["str_attr"] = "a string"
        f.attrs["bytes_attr"] = np.bytes_(b"xyz")
        f["rank3"].attrs["array_attr"] = np.arange(3.0)
        f["g9"].attrs["float_attr"] = np.float32(0.5)
    return names


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    path = tmp_path_factory.mktemp("h5") / "matrix.h5"
    return str(path), _write_matrix(path)


MATRIX_NAMES = (["type_" + t.replace(">", "be") for t in TYPES]
                + ["rank0", "rank1", "rank3", "rank4", "empty", "compact",
                   "chunk_edges", "chunk_rank3", "gzip1", "gzip9_shuffle",
                   "shuffle_only", "fletcher32", "all_filters",
                   "missing_chunks", "masked_chunk", "vlen_string",
                   "fixed_string", "vlen_strings"])


def _same(ours, theirs, what):
    if isinstance(theirs, np.ndarray):
        assert isinstance(ours, np.ndarray), what
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, \
            (what, ours.dtype, theirs.dtype, ours.shape, theirs.shape)
        if theirs.dtype == object:
            assert list(ours.reshape(-1)) == list(theirs.reshape(-1)), what
        else:
            assert ours.tobytes() == theirs.tobytes(), what
    else:
        assert type(ours) is type(theirs) and ours == theirs, \
            (what, ours, theirs)


def test_matrix_covers_every_dataset(matrix):
    assert sorted(matrix[1]) == sorted(MATRIX_NAMES)


@pytest.mark.parametrize("name", MATRIX_NAMES)
def test_reader_equals_h5py(matrix, name):
    path, _ = matrix
    with h5py.File(path, "r") as h, hdf5_format.File(path) as m:
        ds, theirs = m[name], h[name]
        _same(ds[()], theirs[()], name)
        assert ds.shape == theirs.shape and ds.dtype == theirs.dtype
        for k in theirs.attrs:
            _same(ds.attrs[k], theirs.attrs[k], f"{name}@{k}")


@pytest.mark.parametrize("group", ["/", "g9", "g300", "a", "a/b/c"])
def test_groups_and_attributes_equal_h5py(matrix, group):
    path, _ = matrix
    with h5py.File(path, "r") as h, hdf5_format.File(path) as m:
        g, hg = m[group] if group != "/" else m.root, h[group]
        assert list(g) == list(hg) and len(g) == len(hg)
        for k in hg.attrs:
            _same(g.attrs[k], hg.attrs[k], f"{group}@{k}")
        for k in hg:
            if isinstance(hg[k], h5py.Dataset):
                _same(g[k][()], hg[k][()], f"{group}/{k}")
    with hdf5_format.File(path) as m:
        assert "a/b/c/deep" in m and "a/b/nope" not in m
        np.testing.assert_array_equal(m["a/b/c/deep"][()], np.eye(3))


def test_fletcher32_catches_a_flipped_byte(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(64, dtype="f4"),
                         fletcher32=True, chunks=(64,))
        addr = f["x"].id.get_chunk_info(0).byte_offset
    raw = bytearray(open(path, "rb").read())
    raw[addr + 10] ^= 0x40
    open(path, "wb").write(bytes(raw))
    with hdf5_format.File(path) as m:
        with pytest.raises(hdf5_format.HDF5FormatError, match="fletcher32"):
            m["x"][()]


@pytest.mark.parametrize("kind", ["libver_latest", "track_order"])
def test_newer_formats_are_refused_by_name(tmp_path, kind):
    path = str(tmp_path / f"{kind}.h5")
    kw = ({"libver": "latest"} if kind == "libver_latest"
          else {"track_order": True})
    with h5py.File(path, "w", **kw) as f:
        f["x"] = np.arange(3)
    with pytest.raises(NotImplementedError, match="ROADMAP A6, HDF5") as ei:
        with hdf5_format.File(path) as m:
            m["x"][()]
    assert ("superblock version 3" if kind == "libver_latest"
            else "version-2 object header") in str(ei.value)


def test_a_file_that_is_no_hdf5_is_a_format_error(tmp_path):
    path = tmp_path / "x.h5"
    path.write_bytes(b"not an HDF5 file at all" * 40)
    with pytest.raises(hdf5_format.HDF5FormatError, match="signature"):
        hdf5_format.File(str(path))
    assert not hdf5.is_hdf5_file(str(path))


# ---------------------------------------------------------------------------
# The writer
# ---------------------------------------------------------------------------

def _tree():
    rng = np.random.default_rng(1)
    return {
        "data": {f"layer{i:02d}": {"0": rng.normal(size=(3, 4)).astype("f4"),
                                   "1": rng.normal(size=3).astype("f4")}
                 for i in range(60)},
        "big": {f"m{i:03d}": np.int64(i) for i in range(300)},
        "iter": np.int64(7), "learned_net": "snap_iter_7.caffemodel.h5",
        "f64": rng.normal(size=(2, 2, 2)), "i8": np.arange(5, dtype="i1"),
        "be": np.arange(4, dtype=">i4"), "empty": np.zeros((0, 3), "f4"),
        "scalar_f4": np.float32(1.25)}


def _check_tree(h, tree, where=""):
    assert sorted(h.keys()) == sorted(tree), where
    for k, v in tree.items():
        if isinstance(v, dict):
            _check_tree(h[k], v, f"{where}/{k}")
        elif isinstance(v, str):
            assert h[k][()] == v.encode(), k
        else:
            got = h[k][()]
            want = np.asarray(v)
            assert np.asarray(got).dtype == want.dtype, k
            assert np.asarray(got).tobytes() == want.tobytes(), k


def test_writer_reads_back_through_h5py_and_the_port(tmp_path):
    path = str(tmp_path / "w.h5")
    tree = _tree()
    hdf5_format.write(path, tree)
    with h5py.File(path, "r") as h:
        _check_tree(h, tree)
        assert h["learned_net"].dtype.kind == "S"
    with hdf5_format.File(path) as m:
        _check_tree(m, tree)


def test_writer_files_read_through_the_jax_package(tmp_path):
    rng = np.random.default_rng(2)
    layers = {"conv1": [rng.normal(size=(4, 3, 2, 2)), rng.normal(size=4)],
              "ip": [rng.normal(size=(5, 6))], "b": []}
    hdf5.save_model_hdf5(str(tmp_path / "m.h5"), layers)
    got = jhdf5.load_model_hdf5(str(tmp_path / "m.h5"))
    assert set(got) == set(layers)
    for k, blobs in layers.items():
        assert [b.tobytes() for b in got[k]] == \
            [np.asarray(b, np.float32).tobytes() for b in blobs]
    hist = [rng.normal(size=(3, 2)), rng.normal(size=7)]
    hdf5.save_state_hdf5(str(tmp_path / "s.h5"), 12, hist,
                         learned_net="m.h5", current_step=2)
    st = jhdf5.load_state_hdf5(str(tmp_path / "s.h5"))
    ours = hdf5.load_state_hdf5(str(tmp_path / "s.h5"))
    assert (st["iter"], st["current_step"], st["learned_net"]) == \
        (ours["iter"], ours["current_step"], ours["learned_net"]) == \
        (12, 2, "m.h5")
    for a, b, c in zip(st["history"], ours["history"], hist):
        assert a.tobytes() == b.tobytes() == \
            np.asarray(c, np.float32).tobytes()


def test_the_jax_packages_files_read_through_the_port(tmp_path):
    rng = np.random.default_rng(3)
    layers = {"conv1": [rng.normal(size=(2, 2))], "fc": [rng.normal(size=3),
                                                         rng.normal(size=1)]}
    jhdf5.save_model_hdf5(str(tmp_path / "m.h5"), layers)
    got = hdf5.load_model_hdf5(str(tmp_path / "m.h5"))
    want = jhdf5.load_model_hdf5(str(tmp_path / "m.h5"))
    assert list(got) == list(want)
    for k in want:
        assert [b.tobytes() for b in got[k]] == \
            [b.tobytes() for b in want[k]]
    # the JAX package writes learned_net as a variable-length string
    jhdf5.save_state_hdf5(str(tmp_path / "s.h5"), 3, layers["fc"],
                          learned_net="m.h5")
    assert hdf5.load_state_hdf5(str(tmp_path / "s.h5"))["learned_net"] == \
        jhdf5.load_state_hdf5(str(tmp_path / "s.h5"))["learned_net"] == \
        "m.h5"


def test_blobs_and_hdf5_feed_equal_the_jax_package(tmp_path):
    rng = np.random.default_rng(4)
    paths = []
    for i in range(3):
        blobs = {"data": rng.normal(size=(5 + i, 2, 3)).astype("f8"),
                 "label": rng.integers(0, 4, size=5 + i).astype("i4")}
        if i == 1:
            hdf5.save_hdf5_blobs(str(tmp_path / f"p{i}.h5"), blobs)
        else:
            jhdf5.save_hdf5_blobs(str(tmp_path / f"p{i}.h5"), blobs)
        paths.append(f"p{i}.h5")
    src = tmp_path / "list.txt"
    src.write_text("\n".join(paths) + "\n\n")
    assert hdf5.read_source_list(str(src)) == \
        jhdf5.read_source_list(str(src))
    for p in paths:
        a = hdf5.load_hdf5_blobs(str(tmp_path / p))
        b = jhdf5.load_hdf5_blobs(str(tmp_path / p))
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32
            assert a[k].tobytes() == b[k].tobytes()
    for shuffle in (False, True):
        ours = hdf5.hdf5_feed(str(src), ["data", "label"], 4,
                              shuffle=shuffle, seed=9)
        theirs = jhdf5.hdf5_feed(str(src), ["data", "label"], 4,
                                 shuffle=shuffle, seed=9)
        for _ in range(9):
            a, b = next(ours), next(theirs)
            for k in ("data", "label"):
                assert a[k].tobytes() == b[k].tobytes(), (shuffle, k)


# ---------------------------------------------------------------------------
# snapshot_format: HDF5 across the two Solvers
# ---------------------------------------------------------------------------

SOLVER = ('type: "Adam"\nbase_lr: 0.001\nmomentum: 0.9\nmomentum2: 0.999\n'
          'delta: 1e-8\nweight_decay: 0.004\nlr_policy: "fixed"\n'
          'snapshot_format: HDF5\n')


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, 10, size=8)
        x = rng.normal(scale=0.3, size=(8, 3, 32, 32))
        for i, k in enumerate(labels):
            x[i, :, k, :] += 2.0
        out.append({"data": x.astype(np.float32),
                    "label": labels.astype(np.float32)})
    return out


def _port(seed=0):
    return Solver(load_solver_prototxt_with_net(SOLVER, cifar10_quick(8, 8)),
                  seed=seed, device="cpu")


def _jax(seed=0):
    return JaxSolver(jax_sp(SOLVER, jax_quick(8, 8)), seed=seed)


def _assert_equal_solvers(port, jsolver):
    import jax
    jstate = jax.device_get(jsolver.state)
    assert port.iter == int(jsolver.iter)
    for k, blobs in port.params.items():
        for i, b in enumerate(blobs):
            assert b.numpy().tobytes() == np.asarray(
                jsolver.params[k][i]).tobytes(), (k, i)
            for s in port.state:
                assert port.state[s][k][i].numpy().tobytes() == \
                    np.asarray(jstate[s][k][i]).tobytes(), (s, k, i)


def _track(port, jsolver, batches):
    port.set_train_data(iter(batches))
    jsolver.set_train_data(iter(batches))
    for _ in batches:
        np.testing.assert_allclose(float(port.step(1)),
                                   float(jsolver.step(1)), rtol=RTOL,
                                   atol=ATOL)
    for k, blobs in port.params.items():
        for i, b in enumerate(blobs):
            np.testing.assert_allclose(b.numpy(), np.asarray(
                jsolver.params[k][i]), rtol=RTOL, atol=ATOL,
                err_msg=f"{k}[{i}]")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hdf5_snapshots_restore_across_the_two_solvers(tmp_path, writer):
    first = _port() if writer == "port" else _jax()
    first.set_train_data(iter(_batches(3, 1)))
    first.step(3)
    model, state = first.snapshot_caffe(str(tmp_path / writer))
    assert model.endswith("_iter_3.caffemodel.h5") and \
        state.endswith("_iter_3.solverstate.h5")
    if writer == "port":
        port, jsolver = first, _jax(seed=5)
        jsolver.restore_caffe(state)
    else:
        port, jsolver = _port(seed=5), first
        port.restore_caffe(state)
    _assert_equal_solvers(port, jsolver)
    _track(port, jsolver, _batches(10, 2))


def test_load_weights_reads_the_jax_caffemodel_h5(tmp_path):
    j = _jax(seed=3)
    j.set_train_data(iter(_batches(1, 3)))
    j.step(1)
    model, _ = j.snapshot_caffe(str(tmp_path / "j"))
    port = _port(seed=11)
    port.load_weights(model)
    for k, blobs in port.params.items():
        for i, b in enumerate(blobs):
            assert b.numpy().tobytes() == np.asarray(
                j.params[k][i]).tobytes()
    # a history whose shape is flipped is refused before anything moves
    bad = str(tmp_path / "bad.solverstate.h5")
    st = hdf5.load_state_hdf5(model.replace("caffemodel", "solverstate"))
    st["history"][0] = st["history"][0].reshape(
        st["history"][0].shape[::-1])
    hdf5.save_state_hdf5(bad, st["iter"], st["history"],
                         learned_net=model)
    before = {k: [b.clone() for b in v] for k, v in port.params.items()}
    with pytest.raises(ValueError, match="incompatible"):
        port.restore_caffe(bad)
    assert all(torch.equal(a, b) for k in before
               for a, b in zip(before[k], port.params[k]))
