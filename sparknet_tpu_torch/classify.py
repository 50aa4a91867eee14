"""Classifier / Detector — prediction wrappers over a trained net (the
pycaffe ``Classifier``/``Detector`` analogs; reference:
caffe/python/caffe/classifier.py, detector.py, and the oversample helper
in caffe/python/caffe/io.py:340-384).

The reference exposes pycaffe as an alternative binding to the C++ core;
this framework's core *is* Python, so these are thin layers: load
prototxt + weights, preprocess (resize → mean subtract → center crop /
10-crop oversample / R-CNN context-padded window warp), batched forward.

The port's own copy of ``sparknet_tpu/classify.py``.  The net is built
on ``device`` (cuda unless the caller asks for the CPU), takes its
weights through the port's ``.caffemodel`` reader, and runs its forward
under ``torch.inference_mode()`` with TF32 off, so on the card an
ACROSS_CHANNELS LRN launches the inference kernel ``lrn_across_channels``
(CaffeNet's norm1 and norm2: two launches a forward).  Preprocessing is
the JAX module's, in numpy on the host.  ``RemoteClassifier`` runs the
same preprocessing and posts each crop to a running
``python -m sparknet_tpu_torch.tools.serve`` (``http_json``,
``remote_classify``: stdlib ``urllib``), whose engine batches the crops
on the server's device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .utils.device import full_f32, resolve_device

def preprocess_image(img: np.ndarray, image_dims: tuple[int, int], *,
                     channel_swap: tuple[int, ...] | None = None,
                     raw_scale: float | None = None) -> np.ndarray:
    """(C,H,W) or (H,W,C)/(H,W) float image -> (C, *image_dims), with
    channel permutation and raw_scale applied — the ONE preprocessing
    implementation shared by the local :class:`Classifier` and the
    serving plane's :class:`RemoteClassifier`, so a prediction means the
    same thing whichever side of the wire ran it.  mean/input_scale
    happen per-crop at net-input size (:func:`transform_crops`)."""
    arr = np.asarray(img, np.float32)
    if arr.ndim == 2:
        arr = arr[None]
    elif arr.ndim == 3 and arr.shape[0] not in (1, 3):
        arr = arr.transpose(2, 0, 1)  # HWC -> CHW
    if channel_swap is not None and arr.shape[0] == len(channel_swap):
        arr = arr[list(channel_swap)]
    if raw_scale is not None:
        arr = arr * raw_scale
    h, w = image_dims
    if arr.shape[-2:] != (h, w):
        from .data.db import _warp
        arr = _warp(arr, h, w)
    return arr


def transform_crops(crops: np.ndarray,
                    mean: np.ndarray | float | None = None,
                    input_scale: float | None = None) -> np.ndarray:
    """Per-crop transform at net-input size (crop-sized / per-channel /
    scalar mean, then input_scale) — shared local/remote, like
    :func:`preprocess_image`."""
    if mean is not None:
        crops = crops - mean
    if input_scale is not None:
        crops = crops * input_scale
    return crops


def oversample(images: np.ndarray, crop: int) -> np.ndarray:
    """(N, C, H, W) -> (10N, C, crop, crop): four corners + center, and
    their mirrors (reference: caffe/python/caffe/io.py:340-384, in NCHW)."""
    n, c, h, w = images.shape
    ys = (0, h - crop)
    xs = (0, w - crop)
    cy, cx = (h - crop) // 2, (w - crop) // 2
    wins = [(y, x) for y in ys for x in xs] + [(cy, cx)]
    crops = np.empty((10 * n, c, crop, crop), images.dtype)
    for i, (y, x) in enumerate(wins):
        view = images[:, :, y:y + crop, x:x + crop]
        crops[i * n:(i + 1) * n] = view
        crops[(5 + i) * n:(6 + i) * n] = view[:, :, :, ::-1]
    return crops


class Classifier:
    """Load a deploy prototxt + weights and predict class probabilities.

    ``predict(inputs, oversample=True)`` matches Classifier.predict
    semantics: inputs are resized to ``image_dims``, then either
    center-cropped or 10-crop oversampled to the net's input size; crop
    predictions are averaged per input."""

    def __init__(self, model_file: str, pretrained_file: str | None = None,
                 image_dims: tuple[int, int] | None = None,
                 mean: np.ndarray | float | None = None,
                 input_scale: float | None = None,
                 raw_scale: float | None = None,
                 channel_swap=None, *,
                 device: str | torch.device = "cuda"):
        from .graph.net import Net
        from .proto import NetState, Phase, load_net_prototxt

        self.device = resolve_device(device)
        net_param = load_net_prototxt(model_file)
        self.net = Net(net_param, NetState(Phase.TEST))
        params = self.net.init(torch.Generator().manual_seed(0),
                               device=self.device)
        if pretrained_file:
            from .solvers.solver import load_weights_into
            params = load_weights_into(self.net, params, pretrained_file)
        self.params = params
        self.input_name = next(iter(self.net.input_blobs))
        in_shape = self.net.input_blobs[self.input_name]
        self.crop = in_shape[-1]
        self.channels = in_shape[1]
        self.image_dims = tuple(image_dims or (self.crop, self.crop))
        self.mean = mean
        self.input_scale = input_scale
        self.raw_scale = raw_scale
        # channel permutation applied after HWC->CHW, before raw_scale —
        # classifier.py's RGB->BGR default path (Transformer
        # set_channel_swap ordering)
        self.channel_swap = tuple(channel_swap) if channel_swap else None

    def _fwd(self, crops: np.ndarray) -> np.ndarray:
        """The net's last output for a batch of crops, (N, ...) float32 on
        the host: one forward on ``device``, f32 with TF32 off."""
        x = torch.from_numpy(np.ascontiguousarray(crops, np.float32))
        with torch.inference_mode(), full_f32():
            out = self.net.apply(self.params,
                                 {self.input_name: x.to(self.device)},
                                 train=False)[self.net.output_blobs[-1]]
            return out.float().cpu().numpy()

    def _preprocess(self, img: np.ndarray) -> np.ndarray:
        """Delegates to the shared :func:`preprocess_image` (the
        Transformer is configured with the net blob shape, so a
        pycaffe-style mean array is crop-sized)."""
        return preprocess_image(img, self.image_dims,
                                channel_swap=self.channel_swap,
                                raw_scale=self.raw_scale)

    def _transform_crops(self, crops: np.ndarray) -> np.ndarray:
        return transform_crops(crops, self.mean, self.input_scale)

    def predict(self, inputs: Sequence[np.ndarray],
                oversample_crops: bool = True) -> np.ndarray:
        """Class probabilities, (N, classes); oversampled crops averaged
        per input (classifier.py predict)."""
        batch = np.stack([self._preprocess(im) for im in inputs])
        n = len(batch)
        if oversample_crops:
            crops = oversample(batch, self.crop)
        else:
            y = (batch.shape[2] - self.crop) // 2
            x = (batch.shape[3] - self.crop) // 2
            crops = batch[:, :, y:y + self.crop, x:x + self.crop]
        # the prediction top: last single output (deploy nets end in prob)
        out = self._fwd(self._transform_crops(crops))
        out = out.reshape(out.shape[0], -1)
        if oversample_crops:
            out = out.reshape(10, n, -1).mean(axis=0)
        return out


class Detector(Classifier):
    """Windowed (R-CNN style) detection: classify a list of image crops,
    each extracted with ``context_pad`` surrounding context and warped to
    the net input (reference: caffe/python/caffe/detector.py
    detect_windows + the window crop of window_data_layer.cpp)."""

    def __init__(self, model_file: str, pretrained_file: str | None = None,
                 mean: np.ndarray | float | None = None,
                 input_scale: float | None = None,
                 raw_scale: float | None = None,
                 channel_swap=None,
                 context_pad: int = 0, *,
                 device: str | torch.device = "cuda"):
        super().__init__(model_file, pretrained_file, mean=mean,
                         input_scale=input_scale, raw_scale=raw_scale,
                         channel_swap=channel_swap, device=device)
        self.context_pad = context_pad

    def detect_windows(self, images_windows: Sequence[tuple[np.ndarray,
                                                            Sequence]]):
        """``images_windows``: (image, [(y1, x1, y2, x2), ...]) pairs.
        Returns a flat list of {'window', 'prediction'} dicts, matching
        detect_windows' output shape."""
        from .data.db import _crop_warp_window
        crops, metas = [], []
        for image, windows in images_windows:
            arr = np.asarray(image, np.float32)
            if arr.ndim == 2:
                arr = arr[None]
            elif arr.ndim == 3 and arr.shape[0] not in (1, 3):
                arr = arr.transpose(2, 0, 1)
            if self.channel_swap is not None and \
                    arr.shape[0] == len(self.channel_swap):
                arr = arr[list(self.channel_swap)]
            if self.raw_scale is not None:
                arr = arr * self.raw_scale
            for (y1, x1, y2, x2) in windows:
                # mean/input_scale applied to the full crop buffer after
                # warp+paste — a crop-sized mean stays broadcastable even
                # for border-clipped windows
                win = _crop_warp_window(
                    arr, int(x1), int(y1), int(x2), int(y2), self.crop,
                    self.context_pad, use_square=False, do_mirror=False,
                    mean=None, scale=1.0)
                crops.append(win)
                metas.append((y1, x1, y2, x2))
        out = self._fwd(self._transform_crops(np.stack(crops)))
        out = out.reshape(out.shape[0], -1)
        return [{"window": w, "prediction": out[i]}
                for i, w in enumerate(metas)]


# ---------------------------------------------------------------------------
# Remote (served) classification — the --server path of classify_cli
# ---------------------------------------------------------------------------

def http_json(url: str, payload: dict | None = None,
              timeout: float = 30.0, *, with_status: bool = False):
    """One JSON request against the serving plane (stdlib urllib — the
    client must not need more than the server ships).  HTTP errors with
    a JSON body surface as RuntimeError carrying the server's typed
    ``error``/``reason`` fields; with ``with_status`` the call returns
    (HTTP status, JSON body) instead, errors included."""
    import json
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = json.loads(resp.read().decode())
            return (resp.status, body) if with_status else body
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read().decode())
        except (OSError, ValueError):
            body = {}
        if with_status:
            return e.code, body
        raise RuntimeError(
            f"{url}: HTTP {e.code} "
            f"({body.get('reason') or ''} {body.get('error') or e.reason})"
        ) from None


def remote_classify(url: str, model: str, arr: np.ndarray,
                    tenant: str = "classify",
                    timeout: float = 30.0, *, with_status: bool = False,
                    **fields):
    """Submit ONE (C,H,W) float32 example to a running server
    (``tools/serve.py``) and return its JSON (probs + latency stamps).
    ``fields`` ride along in the request (``version=`` pins a registry
    version); ``with_status`` as :func:`http_json`."""
    import base64
    arr = np.ascontiguousarray(arr, np.float32)
    return http_json(f"{url}/v1/classify", {
        "model": model, "tenant": tenant,
        "shape": list(arr.shape), "dtype": "float32",
        "data_b64": base64.b64encode(arr.tobytes()).decode(),
        "timeout_s": timeout, **fields,
    }, timeout=timeout + 10.0, with_status=with_status)


class RemoteClassifier:
    """Classifier.predict against a running inference server instead of a
    local compile: the SAME preprocessing (:func:`preprocess_image` /
    :func:`transform_crops` / :func:`oversample`) runs client-side, then
    each crop is submitted as its own request — the server's dynamic
    micro-batching coalesces the 10-crop fan-out back into one padded
    forward.  Net geometry (crop size, channels) comes from the server's
    ``/v1/models``, so client and server can never disagree about it."""

    def __init__(self, url: str, model: str,
                 image_dims: tuple[int, int] | None = None,
                 mean: np.ndarray | float | None = None,
                 input_scale: float | None = None,
                 raw_scale: float | None = None,
                 channel_swap=None, tenant: str = "classify",
                 timeout: float = 30.0):
        self.url = url.rstrip("/")
        self.model = model
        self.tenant = tenant
        self.timeout = timeout
        models = http_json(f"{self.url}/v1/models",
                           timeout=timeout).get("models", {})
        if model not in models:
            raise ValueError(
                f"server {url} has no model {model!r} "
                f"(loaded: {sorted(models)})")
        in_shape = models[model]["in_shape"]
        self.channels, self.crop = int(in_shape[0]), int(in_shape[-1])
        self.image_dims = tuple(image_dims or (self.crop, self.crop))
        self.mean = mean
        self.input_scale = input_scale
        self.raw_scale = raw_scale
        self.channel_swap = tuple(channel_swap) if channel_swap else None

    def predict(self, inputs: Sequence[np.ndarray],
                oversample_crops: bool = True) -> np.ndarray:
        """Class probabilities, (N, classes) — Classifier.predict
        semantics over the wire; crop requests are posted concurrently so
        the server micro-batches them."""
        from concurrent.futures import ThreadPoolExecutor
        batch = np.stack([
            preprocess_image(im, self.image_dims,
                             channel_swap=self.channel_swap,
                             raw_scale=self.raw_scale) for im in inputs])
        n = len(batch)
        if oversample_crops:
            crops = oversample(batch, self.crop)
        else:
            y = (batch.shape[2] - self.crop) // 2
            x = (batch.shape[3] - self.crop) // 2
            crops = batch[:, :, y:y + self.crop, x:x + self.crop]
        crops = transform_crops(crops, self.mean, self.input_scale)
        with ThreadPoolExecutor(max_workers=min(32, len(crops))) as ex:
            rows = list(ex.map(
                lambda c: remote_classify(self.url, self.model, c,
                                          tenant=self.tenant,
                                          timeout=self.timeout)["probs"],
                crops))
        out = np.asarray(rows, np.float32)
        if oversample_crops:
            out = out.reshape(10, n, -1).mean(axis=0)
        return out
