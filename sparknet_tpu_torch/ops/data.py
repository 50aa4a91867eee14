"""Input and data layers.

Counterparts of ``sparknet_tpu/ops/data.py`` (reference:
java_data_layer.cpp, caffe InputLayer, memory_data_layer.cpp,
data_layer.cpp, image_data_layer.cpp, window_data_layer.cpp,
dummy_data_layer.cpp, hdf5_data_layer.cpp, hdf5_output_layer.cpp).
``JavaData``, ``Input``, ``MemoryData``, ``Data``, ``ImageData``,
``WindowData`` and ``HDF5Data`` are graph inputs: their tops are bound
by the caller of ``Net.apply`` (for the last four, from ``data/db.py``'s
feeds), and they compute nothing.  ``DummyData`` computes its tops from
fillers.  ``HDF5Output`` consumes its bottoms and writes nothing in the
graph.
"""

from __future__ import annotations

from ..proto.caffe_pb import BlobShape, FillerParameter
from .fillers import fill
from .registry import LayerImpl, register_layer


class InputLikeLayer(LayerImpl):
    def min_bottoms(self) -> int:
        return 0

    def is_input(self) -> bool:
        return True

    def apply(self, lp, params, bottoms, train, gen=None):
        raise RuntimeError(
            f"input layer {lp.name!r} must be fed by the caller, not applied")


@register_layer("JavaData")
class JavaDataLayer(InputLikeLayer):
    def out_shapes(self, lp, bottom_shapes):
        p = lp.sub("java_data_param")
        if p.get("shape") is None:
            raise ValueError(f"JavaData layer {lp.name!r} missing shape")
        shapes = [tuple(BlobShape.from_pmsg(p.get("shape")).dim)]
        if len(lp.top) > 1:
            label = p.get("label_shape")
            shapes.append(tuple(BlobShape.from_pmsg(label).dim)
                          if label is not None else (shapes[0][0],))
        return shapes


@register_layer("Input")
class InputLayer(InputLikeLayer):
    def out_shapes(self, lp, bottom_shapes):
        shapes = [tuple(BlobShape.from_pmsg(s).dim)
                  for s in lp.sub("input_param").get_all("shape")]
        if not shapes:
            raise ValueError(
                f"Input layer {lp.name!r} missing input_param.shape")
        if len(shapes) == 1 and len(lp.top) > 1:
            shapes = shapes * len(lp.top)
        return shapes


@register_layer("MemoryData")
class MemoryDataLayer(InputLikeLayer):
    """Host-fed (data, label) pair with MemoryDataParameter dims."""

    def out_shapes(self, lp, bottom_shapes):
        p = lp.sub("memory_data_param")
        n, c, h, w = (int(p.get(k, 1)) for k in
                      ("batch_size", "channels", "height", "width"))
        return [(n, c, h, w), (n,)]


@register_layer("Data")
class DataLayer(InputLikeLayer):
    """LMDB/LevelDB-backed data layer (data_layer.cpp).  Shape inference
    peeks the first Datum, as DataLayer::DataLayerSetUp does (an encoded
    one's shape read from its fields or its JPEG header, not decoded),
    or a record-shard source's header, and applies ``crop_size``; the
    host feed is ``data/db.py::db_feed``."""

    def out_shapes(self, lp, bottom_shapes):
        from ..data.db import datum_shape, open_db
        from ..data.records import ShardSet, is_records_source
        p = lp.sub("data_param")
        source = p.get("source")
        if source is None:
            raise ValueError(f"Data layer {lp.name!r} missing source")
        batch = int(p.get("batch_size", 1))
        backend = str(p.get("backend", "LEVELDB"))
        if backend.upper() == "RECORDS" or is_records_source(str(source)):
            # record shards: the geometry from the shards' headers
            shards = ShardSet.open(str(source))
            c, h, w = shards.c, shards.h, shards.w
            shards.close()
        else:
            with open_db(str(source), backend) as db:
                c, h, w = datum_shape(db.first()[1], source=str(source))
        crop = int(lp.sub("transform_param").get("crop_size", 0))
        if crop:
            h = w = crop
        shapes = [(batch, c, h, w)]
        if len(lp.top) > 1:
            shapes.append((batch,))
        return shapes


@register_layer("ImageData")
class ImageDataLayer(InputLikeLayer):
    """File-list image data layer (image_data_layer.cpp): ``source`` is a
    text file of "path label" lines; the host feed is
    ``data/db.py::image_data_feed``.  Without a new size the first
    image's own size, read from its header, as ImageDataLayer reads the
    first image for its shape."""

    def out_shapes(self, lp, bottom_shapes):
        from ..data.db import _image_size, read_image_list
        p = lp.sub("image_data_param")
        source = p.get("source")
        if source is None:
            raise ValueError(f"ImageData layer {lp.name!r} missing source")
        batch = int(p.get("batch_size", 1))
        new_h = int(p.get("new_height", 0))
        new_w = int(p.get("new_width", 0))
        c = 3 if bool(p.get("is_color", True)) else 1
        if new_h and new_w:
            h, w = new_h, new_w
        else:
            path, _ = read_image_list(str(source),
                                      str(p.get("root_folder", "")))[0]
            with open(path, "rb") as f:
                h, w = _image_size(f.read(), path)
        crop = int(lp.sub("transform_param").get("crop_size", 0))
        if crop:
            h = w = crop
        shapes = [(batch, c, h, w)]
        if len(lp.top) > 1:
            shapes.append((batch,))
        return shapes


@register_layer("WindowData")
class WindowDataLayer(InputLikeLayer):
    """R-CNN window sampling data layer (window_data_layer.cpp): fg/bg
    windows cropped, context-padded and warped to ``crop_size`` (227 by
    default); the host feed is ``data/db.py::window_data_feed``."""

    def out_shapes(self, lp, bottom_shapes):
        p = lp.sub("window_data_param")
        if p.get("source") is None:
            raise ValueError(f"WindowData layer {lp.name!r} missing source")
        batch = int(p.get("batch_size", 1))
        crop = int(lp.sub("transform_param").get("crop_size", 0)) or 227
        shapes = [(batch, 3, crop, crop)]
        if len(lp.top) > 1:
            shapes.append((batch,))
        return shapes


@register_layer("HDF5Data")
class HDF5DataLayer(InputLikeLayer):
    """Host-fed data layer whose shapes come from the first listed .h5
    file (hdf5_data_layer.cpp); the host feed is
    ``data/hdf5.py::hdf5_feed``."""

    def out_shapes(self, lp, bottom_shapes):
        from ..data.hdf5 import load_hdf5_blobs, read_source_list
        p = lp.sub("hdf5_data_param")
        source = p.get("source")
        batch = int(p.get("batch_size", 1))
        if source is None:
            raise ValueError(f"HDF5Data layer {lp.name!r} missing source")
        blobs = load_hdf5_blobs(read_source_list(str(source))[0],
                                list(lp.top))
        return [(batch,) + blobs[t].shape[1:] for t in lp.top]


@register_layer("HDF5Output")
class HDF5OutputLayer(LayerImpl):
    """Consumes its bottoms and writes nothing inside the graph: the file
    is written on the host (``data/hdf5.py::save_hdf5_blobs``) from any
    blob the net hands back (hdf5_output_layer.cpp)."""

    def min_bottoms(self) -> int:
        return 1

    def out_shapes(self, lp, bottom_shapes):
        return []

    def apply(self, lp, params, bottoms, train, gen=None):
        return []


@register_layer("DummyData")
class DummyDataLayer(LayerImpl):
    """Filler-generated data (dummy_data_layer.cpp), the in-memory source
    of Caffe's own test nets.  Its tops are drawn on the CPU, from the
    CPU ``torch.Generator`` the net passes down, as Dropout's masks are;
    ``Net`` moves them to the device of the run."""

    def min_bottoms(self) -> int:
        return 0

    def needs_rng(self, lp, train: bool = True) -> bool:
        fillers = lp.sub("dummy_data_param").get_all("data_filler")
        return any(f.get("type", "constant") != "constant" for f in fillers)

    def _shapes(self, lp) -> list[tuple[int, ...]]:
        p = lp.sub("dummy_data_param")
        shapes = [tuple(BlobShape.from_pmsg(s).dim)
                  for s in p.get_all("shape")]
        if not shapes:
            # legacy num/channels/height/width, the first value repeating
            rep = {k: [int(v) for v in p.get_all(k)]
                   for k in ("num", "channels", "height", "width")}
            for i in range(max(len(rep["num"]), 1)):
                shapes.append(tuple(
                    (vals[i] if i < len(vals) else vals[0]) if vals else 1
                    for vals in rep.values()))
        ntop = max(len(lp.top), 1)
        if len(shapes) == 1 and ntop > 1:
            shapes = shapes * ntop
        return shapes

    def out_shapes(self, lp, bottom_shapes):
        return self._shapes(lp)

    def apply(self, lp, params, bottoms, train, gen=None):
        fillers = [FillerParameter.from_pmsg(f) for f in
                   lp.sub("dummy_data_param").get_all("data_filler")]
        tops = []
        for i, shape in enumerate(self._shapes(lp)):
            f = fillers[i] if i < len(fillers) else (
                fillers[0] if fillers else FillerParameter())
            if f.type != "constant" and gen is None:
                raise ValueError(
                    f"DummyData layer {lp.name!r} draws its {f.type} "
                    f"filler from a CPU torch.Generator; none was passed")
            tops.append(fill(gen, f, shape))
        return tops
