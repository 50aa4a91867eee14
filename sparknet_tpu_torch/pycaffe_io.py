"""``caffe.io`` shim — the image-IO/preprocessing helpers pycaffe
scripts universally use (reference: caffe/python/caffe/io.py):
``load_image``, ``resize_image``, ``oversample``, and ``Transformer``
(set_transpose / set_channel_swap / set_raw_scale / set_mean /
set_input_scale → ``preprocess``/``deprocess``).

Semantics follow the reference order exactly (io.py Transformer.preprocess):
resize → transpose → channel_swap → raw_scale → mean subtract →
input_scale; deprocess inverts in reverse.  Images are float arrays in
[0, 1] HxWxC (skimage convention), like ``caffe.io.load_image`` returns.

The port's own copy of ``sparknet_tpu/pycaffe_io.py``.  The JAX module
reads and resizes images with PIL, which the card's machine lacks:
``load_image`` decodes on ``device`` through ``data/db.py::load_image``
(on the card a JPEG through nvJPEG at its own size, a CMYK one through
``jpeg.decode_cmyk``; on the CPU PIL for JPEGs, as the JAX module), a
PNG through ``data/png.py`` on either, and ``resize_image`` is
``data/pil_resample.py``, PIL's resize of mode "F" planes, on the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_image", "resize_image", "oversample", "Transformer",
           "blobproto_to_array", "array_to_blobproto",
           "arraylist_to_blobprotovecor_str",
           "blobprotovector_str_to_arraylist",
           "array_to_datum", "datum_to_array"]


# -- proto <-> array converters (reference: io.py:18-95) ---------------------

def _pmsg_of(msg):
    """Accept a caffe_pb2-shim Message or a raw PMessage."""
    return getattr(msg, "_p", msg)


def blobproto_to_array(blob, return_diff: bool = False) -> np.ndarray:
    """BlobProto -> ndarray shaped by ``shape`` or the legacy
    num/channels/height/width dims; ``return_diff`` reads the diff
    channel (io.py blobproto_to_array — the mean-file loading idiom)."""
    from .proto.caffe_pb import blob_to_array
    from .proto.textformat import PMessage
    pm = _pmsg_of(blob)
    if not return_diff:
        arr = blob_to_array(pm)
        # wire-decoded chunks can be read-only frombuffer views; pycaffe
        # scripts mutate the result in place
        return arr if arr.flags.writeable else arr.copy()
    m = PMessage()  # same shape fields, diff presented as data
    for k, v in pm.items():
        if k in ("data", "double_data"):
            continue
        key = {"diff": "data", "double_diff": "double_data"}.get(k, k)
        m.add(key, v)
    return blob_to_array(m)


def array_to_blobproto(arr, diff=None):
    """ndarray -> BlobProto message (new-style shape + packed data;
    io.py array_to_blobproto)."""
    from .proto.caffemodel import array_to_blob
    from .pycaffe_pb2 import _class_for
    pm = array_to_blob(np.asarray(arr, np.float32))
    if diff is not None:
        pm.set("diff", np.asarray(diff, np.float32).reshape(-1))
    return _class_for("BlobProto")(pm)


def arraylist_to_blobprotovecor_str(arraylist) -> bytes:
    """[arrays] -> serialized BlobProtoVector (io.py's name, typo and
    all — the compatibility contract)."""
    from .proto.caffemodel import array_to_blob
    from .proto.textformat import PMessage
    from .proto.wireformat import encode
    vec = PMessage()
    for arr in arraylist:
        vec.add("blobs", array_to_blob(np.asarray(arr, np.float32)))
    return encode(vec, "BlobProtoVector")


def blobprotovector_str_to_arraylist(s: bytes) -> list:
    """Serialized BlobProtoVector -> [arrays] (io.py)."""
    from .proto.caffe_pb import blob_to_array
    from .proto.wireformat import decode
    vec = decode(s, "BlobProtoVector")
    return [blob_to_array(b) for b in vec.get_all("blobs")]


def array_to_datum(arr: np.ndarray, label=None):
    """(C, H, W) array -> Datum message: uint8 data goes in the byte
    string, anything else in float_data (io.py array_to_datum; scripts
    that fill an LMDB write datum.SerializeToString())."""
    from .proto.textformat import PMessage
    from .pycaffe_pb2 import _class_for
    arr = np.asarray(arr)
    if arr.ndim != 3:
        raise ValueError("Incorrect array shape.")
    m = PMessage()
    c, h, w = arr.shape
    m.set("channels", int(c))
    m.set("height", int(h))
    m.set("width", int(w))
    if arr.dtype == np.uint8:
        m.set("data", arr.tobytes())
    else:
        for v in arr.astype(float).flat:
            m.add("float_data", float(v))
    if label is not None:
        m.set("label", int(label))
    return _class_for("Datum")(m)


def datum_to_array(datum) -> np.ndarray:
    """Datum message -> (C, H, W) array: byte data as uint8, else
    float_data (io.py datum_to_array)."""
    pm = _pmsg_of(datum)
    shape = (int(pm.get("channels", 1)), int(pm.get("height", 1)),
             int(pm.get("width", 1)))
    data = pm.get("data")
    if data:
        # copy: frombuffer over bytes is read-only, but scripts mutate
        # the decoded image in place (reference fromstring copies)
        return np.frombuffer(bytes(data),
                             np.uint8).reshape(shape).copy()
    return np.asarray(pm.get_all("float_data"),
                      np.float32).reshape(shape)


def oversample(images, crop_dims) -> np.ndarray:
    """io.py oversample: for each HxWxC image, the 4 corners + center
    crops and their mirrors — returns (10·N, crop_h, crop_w, C).
    (classify.oversample is the NCHW Classifier-internal variant; this
    one matches the reference caffe.io signature and layout.)"""
    ch, cw = int(crop_dims[0]), int(crop_dims[1])
    out = []
    for im in images:
        im = np.asarray(im)
        h, w = im.shape[:2]
        if h < ch or w < cw:
            raise ValueError(f"image {im.shape} smaller than crop "
                             f"{(ch, cw)}")
        starts = [(0, 0), (0, w - cw), (h - ch, 0), (h - ch, w - cw),
                  ((h - ch) // 2, (w - cw) // 2)]
        # Reference ordering (io.py oversample): the 5 crops first, then
        # the same 5 mirrored as a block — scripts index positions
        # (e.g. first 5 = unmirrored).
        crops = [im[y:y + ch, x:x + cw] for y, x in starts]
        out.extend(crops)
        out.extend(c[:, ::-1] for c in crops)
    return np.stack(out)


def load_image(filename: str, color: bool = True,
               device: str | torch.device = "cuda") -> np.ndarray:
    """Load an image as float32 [0, 1] HxWxC (RGB) — io.py load_image
    (skimage.img_as_float): PIL's ``convert("RGB")`` or ``convert("L")``
    pixels, decoded on ``device`` (``data/db.py::load_image``)."""
    from .data.db import load_image as decode
    arr = decode(filename, 0, 0, color, device)
    return np.ascontiguousarray(arr.transpose(1, 2, 0)) / np.float32(255.0)


def resize_image(im: np.ndarray, new_dims, interp_order: int = 1) -> np.ndarray:
    """Resize HxWxC float image to ``new_dims`` (H, W) — io.py
    resize_image.  ``interp_order`` follows the reference's skimage
    spline orders: 0 nearest, 1 bilinear (default), >=2 bicubic; each
    channel is resized as PIL resizes a mode "F" image
    (``data/pil_resample.py``)."""
    from .data import pil_resample
    h, w = int(new_dims[0]), int(new_dims[1])
    method = (pil_resample.NEAREST if interp_order == 0
              else pil_resample.BILINEAR if interp_order == 1
              else pil_resample.BICUBIC)
    chans = [pil_resample.resize(
        np.ascontiguousarray(im[:, :, c], dtype=np.float32), (h, w), method)
        for c in range(im.shape[2])]
    return np.stack(chans, axis=2).astype(im.dtype)


class Transformer:
    """io.py Transformer: per-input preprocessing configuration.

    ``inputs`` maps input blob name -> blob shape (N, C, H, W), exactly
    the pycaffe idiom::

        t = caffe.io.Transformer({'data': net.blobs['data'].shape})
        t.set_transpose('data', (2, 0, 1))
        t.set_mean('data', mu)
        t.set_raw_scale('data', 255)
        t.set_channel_swap('data', (2, 1, 0))
        net.blobs['data'].data[...] = t.preprocess('data', img)
    """

    def __init__(self, inputs: dict):
        self.inputs = {k: tuple(v) for k, v in inputs.items()}
        self.transpose: dict = {}
        self.channel_swap: dict = {}
        self.raw_scale: dict = {}
        self.mean: dict = {}
        self.input_scale: dict = {}

    def _check(self, in_: str) -> None:
        if in_ not in self.inputs:
            raise ValueError(
                f"{in_!r} is not one of the net inputs: "
                f"{sorted(self.inputs)}")

    def set_transpose(self, in_: str, order) -> None:
        self._check(in_)
        if len(order) != len(self.inputs[in_]) - 1:
            raise ValueError(
                "Transpose order needs to have the same number of "
                "dimensions as the input.")
        self.transpose[in_] = tuple(order)

    def set_channel_swap(self, in_: str, order) -> None:
        self._check(in_)
        if len(order) != self.inputs[in_][1]:
            raise ValueError(
                "Channel swap needs to have the same number of "
                "dimensions as the input channels.")
        self.channel_swap[in_] = tuple(order)

    def set_raw_scale(self, in_: str, scale: float) -> None:
        self._check(in_)
        self.raw_scale[in_] = float(scale)

    def set_input_scale(self, in_: str, scale: float) -> None:
        self._check(in_)
        self.input_scale[in_] = float(scale)

    def set_mean(self, in_: str, mean: np.ndarray) -> None:
        """Mean can be a scalar-per-channel vector (C,) or an image
        (C, H, W) matching the input's spatial dims (io.py set_mean,
        incl. its shape checks)."""
        self._check(in_)
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1:
            if mean.shape[0] != self.inputs[in_][1]:
                raise ValueError("Mean channels incompatible with input.")
            mean = mean[:, None, None]
        else:
            if mean.shape[0] != self.inputs[in_][1]:
                raise ValueError("Mean channels incompatible with input.")
            if mean.shape[1:] != tuple(self.inputs[in_][2:]):
                raise ValueError(
                    "Mean shape incompatible with input shape.")
        self.mean[in_] = mean

    def preprocess(self, in_: str, data: np.ndarray) -> np.ndarray:
        """io.py Transformer.preprocess order: resize → transpose →
        channel_swap → raw_scale → mean → input_scale."""
        self._check(in_)
        data = np.asarray(data, np.float32)
        in_dims = self.inputs[in_][2:]
        if data.ndim == 3 and data.shape[:2] != tuple(in_dims):
            data = resize_image(data, in_dims)
        if in_ in self.transpose:
            data = data.transpose(self.transpose[in_])
        if in_ in self.channel_swap:
            data = data[list(self.channel_swap[in_]), :, :]
        if in_ in self.raw_scale:
            data = data * self.raw_scale[in_]
        if in_ in self.mean:
            data = data - self.mean[in_]
        if in_ in self.input_scale:
            data = data * self.input_scale[in_]
        return data

    def deprocess(self, in_: str, data: np.ndarray) -> np.ndarray:
        """Invert preprocess (io.py deprocess order)."""
        self._check(in_)
        data = np.array(np.squeeze(data), np.float32)
        if in_ in self.input_scale:
            data = data / self.input_scale[in_]
        if in_ in self.mean:
            data = data + self.mean[in_]
        if in_ in self.raw_scale:
            data = data / self.raw_scale[in_]
        if in_ in self.channel_swap:
            inv = np.argsort(self.channel_swap[in_])
            data = data[list(inv), :, :]
        if in_ in self.transpose:
            data = data.transpose(np.argsort(self.transpose[in_]))
        return data
