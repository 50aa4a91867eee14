"""HDF5 blob IO: the util/hdf5 and HDF5Data/HDF5Output analog.

The port's own copy of ``sparknet_tpu/data/hdf5.py``, over the port's
HDF5 reader and writer (``data/hdf5_format.py``; no ``h5py``).  Caffe
reads training data from HDF5 (reference: caffe/src/caffe/layers/
hdf5_data_layer.cpp: ``source`` is a text file listing .h5 files, each
holding one dataset per top blob), writes blobs back out
(hdf5_output_layer.cpp), and snapshots to HDF5 when ``snapshot_format:
HDF5`` (net.cpp:889-975, sgd_solver.cpp:275-338).  The same file
conventions are read on the host and fed to the net as ordinary inputs.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from ..utils.retry import io_retry
from . import hdf5_format


def _open_h5(path: str) -> hdf5_format.File:
    """The file open for reading, with bounded retry (a transient
    shared-filesystem error must not end a long run; SPARKNET_IO_*)."""
    return io_retry(hdf5_format.File, path, describe=f"open HDF5 {path}")


def read_source_list(source: str) -> list[str]:
    """The HDF5Data ``source`` convention: a text file of .h5 paths,
    relative ones taken from the list's directory."""
    base = os.path.dirname(source)
    out = []
    with io_retry(open, source, describe=f"open {source}") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(line if os.path.isabs(line)
                           else os.path.join(base, line))
    return out


def load_hdf5_blobs(path: str, keys: list[str] | None = None
                    ) -> dict[str, np.ndarray]:
    """All (or the named) datasets of one .h5 file as float32 arrays, as
    Caffe's ``H5LTread_dataset_float`` reads them."""
    with _open_h5(path) as f:
        names = keys if keys is not None else sorted(f.keys())
        return {k: np.asarray(f[k][()], np.float32) for k in names}


def save_hdf5_blobs(path: str, blobs: dict[str, np.ndarray]) -> None:
    """HDF5Output analog: write named blobs to one .h5 file."""
    hdf5_format.write(path, {k: np.asarray(v) for k, v in blobs.items()})


def hdf5_feed(source: str, tops: list[str], batch_size: int,
              shuffle: bool = False, seed: int = 0,
              ) -> Iterator[dict[str, np.ndarray]]:
    """Endless minibatch stream over the concatenated listed files, the
    HDF5DataLayer feed: file order kept, rows shuffled each epoch from
    ``np.random.default_rng(seed)`` when ``hdf5_data_param.shuffle``."""
    files = read_source_list(source)
    data: dict[str, list] = {t: [] for t in tops}
    for path in files:
        blobs = load_hdf5_blobs(path, tops)
        for t in tops:
            data[t].append(blobs[t])
    cat = {t: np.concatenate(data[t]) for t in tops}
    n = len(next(iter(cat.values())))
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            yield {t: cat[t][idx] for t in tops}


# ---------------------------------------------------------------------------
# The HDF5 snapshot format (SolverParameter.snapshot_format: HDF5)
# ---------------------------------------------------------------------------

def save_model_hdf5(path: str, layer_blobs: "dict[str, list]") -> None:
    """Net::ToHDF5's layout (reference: net.cpp:926-975): group ``data``
    holding one group per layer, datasets ``"0"``, ``"1"``, ... per param
    blob, as float32."""
    hdf5_format.write(path, {"data": {
        name: {str(i): np.asarray(b, np.float32) for i, b in
               enumerate(blobs)}
        for name, blobs in layer_blobs.items()}})


def load_model_hdf5(path: str) -> "dict[str, list]":
    """Net::CopyTrainedLayersFromHDF5's reader (reference: net.cpp:
    889-924): {layer_name: [blob0, blob1, ...]}, layers in name order."""
    out: dict[str, list] = {}
    with _open_h5(path) as f:
        data = f["data"]
        for layer_name in data:
            g = data[layer_name]
            out[layer_name] = [np.asarray(g[str(i)][()], np.float32)
                               for i in range(len(g))]
    return out


def save_state_hdf5(path: str, iteration: int, history: "list",
                    learned_net: str = "", current_step: int = 0) -> None:
    """SGDSolver::SnapshotSolverStateToHDF5's layout (reference:
    sgd_solver.cpp:275-298): scalar int64 ``iter`` and ``current_step``,
    ``learned_net`` as the fixed-length string ``H5LTmake_dataset_string``
    writes, and group ``history`` with datasets ``"0"``...``"n-1"`` in
    learnable-param order."""
    hdf5_format.write(path, {
        "iter": np.int64(iteration), "learned_net": learned_net,
        "current_step": np.int64(current_step),
        "history": {str(i): np.asarray(b, np.float32)
                    for i, b in enumerate(history)}})


def load_state_hdf5(path: str) -> dict:
    """RestoreSolverStateFromHDF5's reader (sgd_solver.cpp:321-338):
    {iter, current_step, learned_net, history}; ``learned_net`` may be a
    fixed-length or a variable-length string."""
    with _open_h5(path) as f:
        learned = ""
        if "learned_net" in f:
            raw = f["learned_net"][()]
            learned = raw.decode() if isinstance(raw, bytes) else str(raw)
        g = f["history"]
        history = [np.asarray(g[str(i)][()], np.float32)
                   for i in range(len(g))]
        return {
            "iter": int(f["iter"][()]),
            "current_step": (int(f["current_step"][()])
                             if "current_step" in f else 0),
            "learned_net": learned,
            "history": history,
        }


def is_hdf5_file(path: str) -> bool:
    """Sniff the 8-byte HDF5 signature (Caffe dispatches restore on the
    .h5 suffix; the magic is sturdier)."""
    return hdf5_format.is_hdf5(path)
