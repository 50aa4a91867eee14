"""compute_image_mean: the mean image of a Datum DB -> mean.binaryproto.

The port's counterpart of ``sparknet_tpu/tools/compute_image_mean.py``
(:16-55; reference: caffe/tools/compute_image_mean.cpp): the per-pixel
mean accumulated in float64 and written as f32 through
``proto/caffemodel.py::save_mean_binaryproto``.

Usage:
  python -m sparknet_tpu_torch.tools.compute_image_mean INPUT_DB \\
      [OUTPUT_FILE] [--backend lmdb|leveldb]
"""

from __future__ import annotations

import argparse

import numpy as np


def compute_mean(input_db: str, backend: str = "lmdb") -> np.ndarray:
    """The (C, H, W) f32 mean of every Datum of ``input_db``, summed in
    float64; raises on an empty DB or records of differing shapes."""
    from ..data.db import datum_to_array, open_db
    acc: np.ndarray | None = None
    n = 0
    with open_db(input_db, backend.upper()) as db:
        for key, val in db.items():
            img, _label = datum_to_array(val, key=key, source=input_db)
            if acc is None:
                acc = np.zeros(img.shape, np.float64)
            elif acc.shape != img.shape:
                raise SystemExit(
                    f"shape mismatch: {img.shape} vs {acc.shape} "
                    "(all datums must agree, compute_image_mean.cpp CHECK)")
            acc += img
            n += 1
            if n % 10000 == 0:
                print(f"processed {n} files")
    if not n:
        raise SystemExit("empty database")
    print(f"processed {n} files")
    return (acc / n).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input_db")
    ap.add_argument("output_file", nargs="?", default=None)
    ap.add_argument("--backend", choices=["lmdb", "leveldb"], default="lmdb")
    args = ap.parse_args(argv)
    mean = compute_mean(args.input_db, args.backend)
    if args.output_file:
        from ..proto.caffemodel import save_mean_binaryproto
        save_mean_binaryproto(args.output_file, mean)
        print(f"wrote {args.output_file}")
    # the reference logs per-channel means
    for c, v in enumerate(mean.reshape(mean.shape[0], -1).mean(axis=1)):
        print(f"mean_value channel [{c}]: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
