"""The HDF5 fixtures under ``sparknet_tpu_torch/data/hdf5_fixtures/``:
Caffe's hdf5_classification data, made here from a seed and cut to size,
written by h5py the way Caffe's example script writes it.

Caffe's example (examples/02-brewing-logreg.ipynb) draws 10,000 rows of
4 features with scikit-learn's ``make_classification`` (2 informative,
2 clusters a class) and writes ``data`` (n x 4 float32) and ``label``
(n float32) with ``compression="gzip", compression_opts=1``.  Here the
rows are drawn with numpy from seed 0 the same way (each class's two
clusters at corners of a square, Gaussian noise, the two other features
noise), 1,000 for training and 250 for the test, chunked, gzip level 1
and shuffled; ``manifest.json`` lists them with their sha256.  The card's
machine has no h5py: ``chip_smoke.py`` phase 5i reads these files with
the port's own reader and trains on them.

    python tests/test_torch_hdf5_fixtures.py --write

rewrites them.  The tests read them with h5py and with the port's reader
and hold both against the rows the generator draws.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys

import numpy as np

DIR = (pathlib.Path(__file__).resolve().parent.parent / "sparknet_tpu_torch"
       / "data" / "hdf5_fixtures")
SPLITS = {"train": 1000, "test": 250}
CHUNK_ROWS = 100


def draw(seed: int = 0) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """The rows of both splits: 2 informative features in 2 clusters a
    class (cluster centres at the corners of a square of side 2, unit
    noise), 2 features of pure noise, classes balanced, rows shuffled."""
    rng = np.random.default_rng(seed)
    corners = np.array([[1, 1], [-1, -1], [1, -1], [-1, 1]], np.float64)
    n = sum(SPLITS.values())
    label = rng.permutation(np.arange(n) % 2)
    cluster = 2 * label + rng.integers(0, 2, size=n)
    x = np.empty((n, 4))
    x[:, :2] = corners[cluster] + rng.normal(size=(n, 2))
    x[:, 2:] = rng.normal(size=(n, 2))
    out, at = {}, 0
    for name, rows in SPLITS.items():
        out[name] = (x[at:at + rows].astype(np.float32),
                     label[at:at + rows].astype(np.float32))
        at += rows
    return out


def write() -> None:
    import h5py
    manifest = {"seed": 0, "writer": "tests/test_torch_hdf5_fixtures.py",
                "h5py": h5py.__version__,
                "hdf5": h5py.version.hdf5_version, "files": {}}
    for name, (x, y) in draw().items():
        path = DIR / f"{name}.h5"
        with h5py.File(path, "w") as f:
            for key, arr in (("data", x), ("label", y)):
                f.create_dataset(key, data=arr, chunks=(CHUNK_ROWS,)
                                 + arr.shape[1:], compression="gzip",
                                 compression_opts=1, shuffle=True)
        (DIR / f"{name}.txt").write_text(f"{name}.h5\n")
        manifest["files"][f"{name}.h5"] = {
            "rows": len(y), "sha256": hashlib.sha256(
                path.read_bytes()).hexdigest()}
    (DIR / "manifest.json").write_text(json.dumps(manifest, indent=1,
                                                  sort_keys=True) + "\n")


def test_fixtures_are_the_generators_rows_through_h5py_and_the_port():
    import pytest
    h5py = pytest.importorskip("h5py")
    from sparknet_tpu_torch.data import hdf5
    manifest = json.loads((DIR / "manifest.json").read_text())
    for name, (x, y) in draw().items():
        path = DIR / f"{name}.h5"
        assert hashlib.sha256(path.read_bytes()).hexdigest() == \
            manifest["files"][f"{name}.h5"]["sha256"]
        with h5py.File(path, "r") as f:
            assert f["data"].compression == "gzip" and f["data"].shuffle
            assert f["data"][()].tobytes() == x.tobytes()
            assert f["label"][()].tobytes() == y.tobytes()
        blobs = hdf5.load_hdf5_blobs(str(path))
        assert blobs["data"].tobytes() == x.tobytes()
        assert blobs["label"].tobytes() == y.tobytes()
        assert hdf5.read_source_list(str(DIR / f"{name}.txt")) == \
            [str(path)]


def test_fixtures_are_small_and_balanced():
    assert sum(p.stat().st_size for p in DIR.iterdir()) < 100_000
    for x, y in draw().values():
        assert set(np.unique(y)) == {0.0, 1.0}
        assert abs(float(y.mean()) - 0.5) < 0.06


if __name__ == "__main__" and "--write" in sys.argv:
    write()
    print(f"wrote {sorted(p.name for p in DIR.iterdir())}")
