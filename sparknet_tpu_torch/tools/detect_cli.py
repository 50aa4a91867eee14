"""detect — windowed R-CNN-style detection from the command line
(reference: caffe/python/detect.py, crop_mode='list').

Input is a CSV with columns ``filename,ymin,xmin,ymax,xmax`` (the
reference's window-list format); output is a CSV with the window
coordinates and per-class scores.  Selective-search proposal mode is not
bundled (the reference shells out to a MATLAB module for it) — pass
explicit windows.

The port's own copy of ``sparknet_tpu/tools/detect_cli.py``, with the
port's ``--device`` (cuda unless the caller asks for the CPU): images
are decoded there by ``pycaffe_io.load_image`` and scored by
``classify.Detector``.

Usage:
  python -m sparknet_tpu_torch.tools.detect_cli WINDOWS.csv OUT.csv \
      --model_def deploy.prototxt [--pretrained_model weights.caffemodel]
      [--mean_file mean.npy] [--input_scale S] [--raw_scale 255]
      [--channel_swap 2,1,0] [--context_pad 16] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import csv
import time

COORD_COLS = ["ymin", "xmin", "ymax", "xmax"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input_file", help="CSV of filename," +
                        ",".join(COORD_COLS))
    parser.add_argument("output_file", help="Output CSV.")
    parser.add_argument("--model_def", required=True)
    parser.add_argument("--pretrained_model", default=None)
    parser.add_argument("--gpu", action="store_true",
                        help="Accepted for compatibility; --device "
                             "places the run.")
    parser.add_argument("--crop_mode", default="list",
                        choices=["list"],
                        help="Only explicit window lists are bundled "
                             "(detect.py's selective_search mode shells "
                             "out to MATLAB).")
    parser.add_argument("--mean_file", default="")
    parser.add_argument("--input_scale", type=float, default=None)
    parser.add_argument("--raw_scale", type=float, default=255.0)
    parser.add_argument("--channel_swap", default="2,1,0")
    parser.add_argument("--context_pad", type=int, default=16)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import numpy as np

    from ..classify import Detector
    from ..pycaffe_io import load_image

    mean = None
    if args.mean_file:
        mean = np.load(args.mean_file)
        if mean.ndim == 3 and mean.shape[1:] != (1, 1):
            mean = mean.mean(1).mean(1)  # detect.py collapses to channels
        if mean.ndim == 1:
            # broadcast against (N, C, H, W) crops on the CHANNEL axis
            mean = mean.reshape(-1, 1, 1)
    channel_swap = ([int(s) for s in args.channel_swap.split(",")]
                    if args.channel_swap else None)

    detector = Detector(
        args.model_def, args.pretrained_model, mean=mean,
        input_scale=args.input_scale, raw_scale=args.raw_scale,
        channel_swap=channel_swap, context_pad=args.context_pad,
        device=args.device)

    # group windows per image, preserving file order
    windows_by_file: dict[str, list] = {}
    with open(args.input_file) as f:
        reader = csv.DictReader(f)
        for row in reader:
            windows_by_file.setdefault(row["filename"], []).append(
                tuple(int(float(row[c])) for c in COORD_COLS))
    if not windows_by_file:
        raise SystemExit(f"no windows in {args.input_file!r}")

    t = time.time()
    results = []
    for fname, windows in windows_by_file.items():
        img = load_image(fname, device=args.device)
        dets = detector.detect_windows([(np.asarray(img).transpose(2, 0, 1),
                                         windows)])
        for d in dets:
            results.append((fname, d["window"], np.asarray(d["prediction"])))
    print(f"Processed {len(results)} windows in {time.time() - t:.3f} s.")

    n_classes = len(results[0][2])
    with open(args.output_file, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename"] + COORD_COLS
                   + [f"class{i}" for i in range(n_classes)])
        for fname, window, pred in results:
            w.writerow([fname] + [int(v) for v in window]
                       + [float(p) for p in pred])
    print(f"Saved to {args.output_file}.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
