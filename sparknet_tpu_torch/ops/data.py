"""Input and data layers.

Counterparts of ``sparknet_tpu/ops/data.py`` (reference:
java_data_layer.cpp, caffe InputLayer, memory_data_layer.cpp,
data_layer.cpp, dummy_data_layer.cpp).  ``JavaData``, ``Input``,
``MemoryData`` and ``Data`` are graph inputs: their tops are bound by the
caller of ``Net.apply`` (for ``Data``, from ``data/db.py::db_feed``), and
they compute nothing.  ``DummyData`` computes its tops from fillers.
``ImageData``, ``WindowData``, ``HDF5Data`` and ``HDF5Output`` are
registered so that a net naming them fails with its ROADMAP item.
"""

from __future__ import annotations

from ..data.db import HDF5_ITEM, IMAGE_DECODING
from ..proto.caffe_pb import BlobShape, FillerParameter
from .fillers import fill
from .registry import LayerImpl, register_layer


class InputLikeLayer(LayerImpl):
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
    peeks the first Datum, as DataLayer::DataLayerSetUp does, and applies
    ``crop_size``; the host feed is ``data/db.py::db_feed``."""

    def out_shapes(self, lp, bottom_shapes):
        from ..data.db import datum_to_array, open_db
        p = lp.sub("data_param")
        source = p.get("source")
        if source is None:
            raise ValueError(f"Data layer {lp.name!r} missing source")
        batch = int(p.get("batch_size", 1))
        with open_db(str(source), str(p.get("backend", "LEVELDB"))) as db:
            img, _label = datum_to_array(db.first()[1], source=str(source))
        c, h, w = img.shape
        crop = int(lp.sub("transform_param").get("crop_size", 0))
        if crop:
            h = w = crop
        shapes = [(batch, c, h, w)]
        if len(lp.top) > 1:
            shapes.append((batch,))
        return shapes


class NotPortedDataLayer(InputLikeLayer):
    """A data layer the port refuses by name: building a net with it
    raises ``NotImplementedError`` naming its ROADMAP item."""

    item = ""

    def out_shapes(self, lp, bottom_shapes):
        raise NotImplementedError(
            f"layer {lp.name!r} ({lp.type}) ({self.item})")


@register_layer("ImageData")
class ImageDataLayer(NotPortedDataLayer):
    item = IMAGE_DECODING


@register_layer("WindowData")
class WindowDataLayer(NotPortedDataLayer):
    item = IMAGE_DECODING


@register_layer("HDF5Data")
class HDF5DataLayer(NotPortedDataLayer):
    item = HDF5_ITEM


@register_layer("HDF5Output")
class HDF5OutputLayer(NotPortedDataLayer):
    item = HDF5_ITEM


@register_layer("DummyData")
class DummyDataLayer(LayerImpl):
    """Filler-generated data (dummy_data_layer.cpp), the in-memory source
    of Caffe's own test nets.  Its tops are drawn on the CPU, from the
    CPU ``torch.Generator`` the net passes down, as Dropout's masks are;
    ``Net`` moves them to the device of the run."""

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
