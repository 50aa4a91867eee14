"""extract_features: run a trained net forward and write named blobs to a
Datum DB.

The port's counterpart of ``sparknet_tpu/tools/extract_features.py``
(:20-82; reference: caffe/tools/extract_features.cpp): the TEST-phase net
on the weights, fed from its own ``Data`` layer, on the card (the
inference LRN kernel), one Datum per sample and blob, keys ``%010d``.

Usage:
  python -m sparknet_tpu_torch.tools.extract_features WEIGHTS \\
      MODEL_PROTOTXT BLOB_NAMES DB_NAMES NUM_BATCHES \\
      [--backend lmdb|leveldb] [--device cuda|cpu]

BLOB_NAMES and DB_NAMES are comma-separated and pair up one to one.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("weights")
    ap.add_argument("model")
    ap.add_argument("blob_names")
    ap.add_argument("db_names")
    ap.add_argument("num_batches", type=int)
    ap.add_argument("--backend", choices=["lmdb", "leveldb"], default="lmdb")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..data.db import array_to_datum
    from .caffe_cli import run_test_net

    blob_names = args.blob_names.split(",")
    db_names = args.db_names.split(",")
    if len(blob_names) != len(db_names):
        raise SystemExit("blob_names and db_names must pair up")
    outputs: dict[str, list[tuple[bytes, bytes]]] = {b: [] for b in
                                                      blob_names}
    idx = 0
    for blobs in run_test_net(args.model, args.weights, args.num_batches,
                                 args.device, blobs=blob_names):
        host = {b: blobs[b].float().cpu().numpy() for b in blob_names}
        for i in range(host[blob_names[0]].shape[0]):
            key = b"%010d" % idx
            idx += 1
            for b in blob_names:
                outputs[b].append((key, array_to_datum(
                    host[b][i].reshape(-1, 1, 1))))
    for b, db in zip(blob_names, db_names):
        if args.backend == "lmdb":
            from ..data.lmdb_io import write_lmdb
            write_lmdb(db, outputs[b])
        else:
            from ..data.leveldb_io import write_leveldb
            write_leveldb(db, outputs[b])
        print(f"extracted {idx} features for blob {b!r} -> {db}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
