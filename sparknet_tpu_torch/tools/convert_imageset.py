"""convert_imageset: an image list file -> an LMDB or LevelDB of Datums
(reference: caffe/tools/convert_imageset.cpp).

The port's counterpart of ``sparknet_tpu/tools/convert_imageset.py``.
LISTFILE lines: "relative/path.jpg <label>".  Flags as the reference
tool's: --backend lmdb|leveldb, --resize_height/--resize_width (force
resize), --shuffle, --gray, --encoded (store the file's compressed bytes;
the size and gray flags then do not apply).  Images are decoded on
``--device`` (the card by default; ``data/db.py::load_image``).

Usage:
  python -m sparknet_tpu_torch.tools.convert_imageset [flags] ROOTFOLDER \\
      LISTFILE DB_NAME
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("listfile")
    ap.add_argument("db_name")
    ap.add_argument("--backend", choices=["lmdb", "leveldb"], default="lmdb")
    ap.add_argument("--resize_height", type=int, default=0)
    ap.add_argument("--resize_width", type=int, default=0)
    ap.add_argument("--shuffle", action="store_true")
    ap.add_argument("--gray", action="store_true")
    ap.add_argument("--encoded", action="store_true",
                    help="store the raw compressed file bytes")
    ap.add_argument("--device", default="cuda",
                    help="where images decode: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..data.db import array_to_datum, load_image, read_image_list
    from ..data.integrity import DataCorruptionError
    from ..data.jpeg import UndecodableImage

    entries = read_image_list(args.listfile, args.root)
    if args.shuffle:
        np.random.default_rng(0).shuffle(entries)

    def items():
        count = skipped = 0
        for i, (path, label) in enumerate(entries):
            key = b"%08d_%s" % (i, os.path.basename(path).encode())
            try:
                if args.encoded:
                    with open(path, "rb") as f:
                        datum = array_to_datum(None, label, encoded=f.read())
                else:
                    img = load_image(path, args.resize_height,
                                     args.resize_width, not args.gray,
                                     args.device)
                    datum = array_to_datum(img.astype(np.uint8), label)
            except (OSError, UndecodableImage, DataCorruptionError) as e:
                # an unreadable file is skipped, as the reference does
                print(f"skip {path}: {e}")
                skipped += 1
                continue
            count += 1
            if count % 1000 == 0:
                print(f"processed {count} files")
            yield key, datum
        print(f"processed {count} files total ({skipped} skipped)")

    if args.backend == "lmdb":
        from ..data.lmdb_io import write_lmdb
        # materialize: the bulk writer sorts keys (already sorted here)
        write_lmdb(args.db_name, list(items()))
    else:
        from ..data.leveldb_io import write_leveldb
        write_leveldb(args.db_name, items())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
