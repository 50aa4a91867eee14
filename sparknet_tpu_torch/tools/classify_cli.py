"""classify — out-of-the-box image classification from the command line
(reference: caffe/python/classify.py).

Input is an image file, a directory of images (--ext picks which), or a
.npy batch; output is a .npy of class probabilities.  Flags mirror the
reference script; --gpu is accepted and ignored (--device places the
run).

The port's own copy of ``sparknet_tpu/tools/classify_cli.py``, with the
port's ``--device`` (cuda unless the caller asks for the CPU): images are
decoded there by ``pycaffe_io.load_image`` (JPEG, PNG, CMYK JPEG on the
card without PIL) and classified by ``classify.Classifier``.  With
``--server URL --model NAME`` the same preprocessing runs here and
``classify.RemoteClassifier`` posts each crop to a running
``python -m sparknet_tpu_torch.tools.serve``, which batches them on its
own device.

Usage:
  python -m sparknet_tpu_torch.tools.classify_cli INPUT OUT.npy \
      --model_def deploy.prototxt [--pretrained_model weights.caffemodel]
      [--center_only] [--images_dim 256,256] [--mean_file mean.npy]
      [--input_scale S] [--raw_scale 255] [--channel_swap 2,1,0]
      [--ext jpg] [--device cuda|cpu]
  python -m sparknet_tpu_torch.tools.classify_cli INPUT OUT.npy \
      --server http://127.0.0.1:8100 --model caffenet [...]
"""

from __future__ import annotations

import argparse
import glob
import os
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input_file",
                        help="Input image, directory, or npy.")
    parser.add_argument("output_file", help="Output npy filename.")
    parser.add_argument("--model_def", default=None,
                        help="Model definition file (required unless "
                             "--server).")
    parser.add_argument("--pretrained_model", default=None,
                        help="Trained model weights file.")
    parser.add_argument("--server", default=None, metavar="URL",
                        help="Submit to a running tools/serve.py instead "
                             "of running the net locally (e.g. "
                             "http://127.0.0.1:8100); preprocessing is "
                             "the same shared pipeline either way.")
    parser.add_argument("--model", default=None,
                        help="Served model name for --server (e.g. "
                             "lenet, caffenet).")
    parser.add_argument("--gpu", action="store_true",
                        help="Accepted for compatibility; --device "
                             "places the run.")
    parser.add_argument("--center_only", action="store_true",
                        help="Predict from the center crop alone instead "
                             "of averaging the 10-crop oversample.")
    parser.add_argument("--images_dim", default="256,256",
                        help="Canonical 'height,width' of input images.")
    parser.add_argument("--mean_file", default="",
                        help="npy mean image (C,H,W) or per-channel "
                             "vector; '' for no mean subtraction.")
    parser.add_argument("--input_scale", type=float, default=None)
    parser.add_argument("--raw_scale", type=float, default=255.0)
    parser.add_argument("--channel_swap", default="2,1,0",
                        help="Channel permutation (RGB -> BGR default).")
    parser.add_argument("--ext", default="jpg",
                        help="Image extension for directory inputs.")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import numpy as np

    from ..classify import Classifier, RemoteClassifier
    from ..pycaffe_io import load_image

    image_dims = [int(s) for s in args.images_dim.split(",")]
    mean = np.load(args.mean_file) if args.mean_file else None
    if mean is not None and mean.ndim == 1:
        # per-channel vector: broadcast on the channel axis of NCHW crops
        mean = mean.reshape(-1, 1, 1)
    channel_swap = ([int(s) for s in args.channel_swap.split(",")]
                    if args.channel_swap else None)

    if args.server:
        if not args.model:
            parser.error("--server requires --model (the served name)")
        classifier = RemoteClassifier(
            args.server, args.model, image_dims=image_dims,
            mean=mean, input_scale=args.input_scale,
            raw_scale=args.raw_scale, channel_swap=channel_swap)
    else:
        if not args.model_def:
            parser.error("--model_def is required (or use --server)")
        classifier = Classifier(
            args.model_def, args.pretrained_model, image_dims=image_dims,
            mean=mean, input_scale=args.input_scale,
            raw_scale=args.raw_scale, channel_swap=channel_swap,
            device=args.device)

    t = time.time()
    if args.input_file.endswith("npy"):
        inputs = list(np.load(args.input_file).astype(np.float32))
    elif os.path.isdir(args.input_file):
        inputs = [load_image(f, device=args.device) for f in sorted(
            glob.glob(os.path.join(args.input_file, "*." + args.ext)))]
    else:
        inputs = [load_image(args.input_file, device=args.device)]
    if not inputs:
        raise SystemExit(f"no inputs found in {args.input_file!r}")
    print(f"Classifying {len(inputs)} inputs.")

    predictions = classifier.predict(
        inputs, oversample_crops=not args.center_only)
    print(f"Done in {time.time() - t:.2f} s.")
    np.save(args.output_file, predictions)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
