"""The port's ``tools/convert.py`` against the root ``tools/convert.py``
(the JAX package's), on the CPU: over the same LMDB, LevelDB, HDF5 and
tar sources, with the backend given or sniffed, both print the same JSON
summary line and write shard files equal byte for byte.  The tar source
holds the committed ImageNet-sized JPEG fixtures and an undecodable
entry; the port decodes with ``--device cpu`` (PIL and the plain
resize), which gives the JAX package's pixels (tests/test_torch_imagenet
.py)."""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import shutil

import numpy as np
import pytest

from sparknet_tpu_torch.data.db import array_to_datum
from sparknet_tpu_torch.data.leveldb_io import write_leveldb
from sparknet_tpu_torch.data.lmdb_io import write_lmdb
from sparknet_tpu_torch.tools import convert
from test_torch_imagenet import write_tars
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "root_tools_convert", ROOT / "tools" / "convert.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _source(d: pathlib.Path, kind: str) -> tuple[str, list[str]]:
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, size=(14, 3, 6, 5)).astype(np.uint8)
    labels = rng.integers(0, 7, size=14)
    items = [(b"%08d" % i, array_to_datum(imgs[i], int(labels[i])))
             for i in range(14)]
    if kind == "lmdb":
        write_lmdb(str(d / "src"), items)
        return str(d / "src"), []
    if kind == "leveldb":
        write_leveldb(str(d / "src"), items)
        return str(d / "src"), []
    if kind == "hdf5":
        h5py = pytest.importorskip("h5py")
        with h5py.File(d / "src.h5", "w") as f:
            f["data"] = imgs.astype(np.float32)
            f["label"] = labels.astype(np.float64)
        return str(d / "src.h5"), []
    tar_dir, label_file = write_tars(d, 2, 6, planted={4}, seed=2)
    return tar_dir, ["--labels", label_file, "--resize", "20"]


@pytest.mark.parametrize("backend", [None, "given"])
@pytest.mark.parametrize("kind", ["lmdb", "leveldb", "hdf5", "tar"])
def test_convert_line_and_shards_equal_the_root_tool(tmp_path, capsys,
                                                     kind, backend):
    source, extra = _source(tmp_path, kind)
    extra = extra + (["--backend", kind] if backend else []) + \
        ["--shard-mb", "1"]
    out = str(tmp_path / "shards")
    capsys.readouterr()
    assert _jax_tool().main(["--source", source, "--out", out] + extra) == 0
    theirs = capsys.readouterr().out
    shutil.move(out, str(tmp_path / "jax_shards"))
    assert convert.main(["--source", source, "--out", out, "--device",
                         "cpu"] + extra) == 0
    ours = capsys.readouterr().out
    assert ours == theirs
    line = json.loads(ours)
    assert line["backend"] == kind and line["records"] == (
        11 if kind == "tar" else 14)
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(tmp_path / "jax_shards"))
    for name in names:
        assert (pathlib.Path(out) / name).read_bytes() == \
            (tmp_path / "jax_shards" / name).read_bytes(), name


def test_convert_quarantines_one_record_and_goes_on(tmp_path, capsys,
                                                   monkeypatch):
    """A record whose Datum is cut short goes through the quarantine (a
    budget of one) and the port converts every other record, rolling
    shards at ``SPARKNET_RECORD_SHARD_MB``; the shards hold the records
    the root tool writes before the bad one, byte for byte, and the rest
    after them.  The root tool stops at the bad record: its source is a
    generator, which ends at its first raise (ROADMAP C)."""
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, size=(40, 3, 100, 100)).astype(np.uint8)
    items = [(b"%08d" % i, array_to_datum(imgs[i], i % 5))
             for i in range(40)]
    items[7] = (items[7][0], items[7][1][:-9])
    write_lmdb(str(tmp_path / "src"), items)
    monkeypatch.setenv("SPARKNET_RECORD_SHARD_MB", "1")
    monkeypatch.setenv("SPARKNET_QUARANTINE_RECORDS", "1")
    out = str(tmp_path / "shards")
    capsys.readouterr()
    assert _jax_tool().main(["--source", str(tmp_path / "src"), "--out",
                             out]) == 0
    theirs = capsys.readouterr().out
    shutil.move(out, str(tmp_path / "jax_shards"))
    assert convert.main(["--source", str(tmp_path / "src"), "--out",
                         out]) == 0
    line, jline = json.loads(capsys.readouterr().out), json.loads(theirs)
    assert line["quarantine"] == jline["quarantine"]
    assert line["quarantine"]["total_bad"] == 1
    assert (line["records"], jline["records"]) == (39, 7)
    assert len(line["shards"]) == 2
    from sparknet_tpu_torch.data.records import ShardSet
    ss, jss = ShardSet.open(out), ShardSet.open(str(tmp_path / "jax_shards"))
    want = [i for i in range(40) if i != 7]
    for j in range(ss.count):
        shard, k = ss.locate(j)
        img, label = shard.read(k)
        assert img.tobytes() == imgs[want[j]].tobytes()
        assert label == want[j] % 5
        if j < jss.count:
            jshard, jk = jss.locate(j)
            assert jshard.read_raw(jk) == shard.read_raw(k)
    ss.close()
    jss.close()


def test_convert_refuses_what_it_cannot_sniff(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="cannot sniff"):
        convert.main(["--source", str(tmp_path / "empty"), "--out",
                      str(tmp_path / "o")])
