"""Programmatic model DSL — the ``Layers.scala`` analog.

The reference builds ``LayerParameter``/``NetParameter`` protobufs inline
from Scala (reference: src/main/scala/libs/Layers.scala:18-137 — RDDLayer,
ConvolutionLayer, PoolingLayer, InnerProductLayer, ReLULayer,
SoftmaxWithLoss, NetParam).  Here the builders produce the same typed config
objects the prototxt parser does, so DSL-built and prototxt-loaded nets are
indistinguishable downstream.

The port's own copy of ``sparknet_tpu/models/dsl.py``, holding the
builders of the layer types the port implements.
"""

from __future__ import annotations

from typing import Any, Sequence

from ..proto.caffe_pb import LayerParameter, NetParameter, ParamSpec, Phase
from ..proto.textformat import PMessage


def msg(**kwargs: Any) -> PMessage:
    """Build a PMessage from kwargs; dicts nest, lists/tuples repeat."""
    m = PMessage()
    for k, v in kwargs.items():
        if isinstance(v, dict):
            m.add(k, msg(**v))
        elif isinstance(v, PMessage):
            m.add(k, v)
        elif isinstance(v, (list, tuple)):
            for item in v:
                m.add(k, msg(**item) if isinstance(item, dict) else item)
        else:
            m.add(k, v)
    return m


def layer(name: str, type: str, bottoms: Sequence[str] = (),
          tops: Sequence[str] = (), phase: Phase | None = None,
          param: Sequence[dict] | None = None,
          **type_params: dict | PMessage) -> LayerParameter:
    """Generic layer builder; ``type_params`` maps sub-config names
    (e.g. convolution_param) to dicts."""
    lp = LayerParameter(
        name=name, type=type, bottom=list(bottoms), top=list(tops), phase=phase)
    if param:
        lp.param = [
            ParamSpec(**p,
                      raw_lr_mult=p.get("lr_mult"),
                      raw_decay_mult=p.get("decay_mult"))
            for p in param]
    for key, sub in type_params.items():
        lp.params[key] = sub if isinstance(sub, PMessage) else msg(**sub)
    return lp


def net_param(name: str, layers: Sequence[LayerParameter]) -> NetParameter:
    """NetParam (reference: Layers.scala:130-137)."""
    return NetParameter(name=name, layer=list(layers))


def java_data_layer(name: str, tops: Sequence[str], phase: Phase,
                    data_shape: Sequence[int],
                    label_shape: Sequence[int] | None = None) -> LayerParameter:
    """Host-fed data layer (RDDLayer analog; reference: Layers.scala:18-40)."""
    p: dict[str, Any] = {"shape": {"dim": list(data_shape)}}
    if label_shape is not None:
        p["label_shape"] = {"dim": list(label_shape)}
    return layer(name, "JavaData", tops=tops, phase=phase, java_data_param=p)


def convolution_layer(name: str, bottom: str, top: str, *, num_output: int,
                      kernel: int | tuple[int, int], stride: int = 1,
                      pad: int = 0, group: int = 1,
                      weight_filler: dict | None = None,
                      bias_filler: dict | None = None,
                      param: Sequence[dict] | None = None) -> LayerParameter:
    """ConvolutionLayer (reference: Layers.scala:42-63)."""
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    cp: dict[str, Any] = {
        "num_output": num_output, "kernel_h": kh, "kernel_w": kw,
        "stride": stride, "pad": pad, "group": group,
    }
    if weight_filler:
        cp["weight_filler"] = weight_filler
    if bias_filler:
        cp["bias_filler"] = bias_filler
    return layer(name, "Convolution", [bottom], [top], param=param,
                 convolution_param=cp)


def pooling_layer(name: str, bottom: str, top: str, *, pool: str = "MAX",
                  kernel: int = 2, stride: int = 1, pad: int = 0,
                  global_pooling: bool = False) -> LayerParameter:
    """PoolingLayer (reference: Layers.scala:65-86)."""
    pp: dict[str, Any] = {"pool": pool, "stride": stride, "pad": pad}
    if global_pooling:
        pp["global_pooling"] = True
    else:
        pp["kernel_size"] = kernel
    return layer(name, "Pooling", [bottom], [top], pooling_param=pp)


def inner_product_layer(name: str, bottom: str, top: str, *, num_output: int,
                        weight_filler: dict | None = None,
                        bias_filler: dict | None = None,
                        param: Sequence[dict] | None = None) -> LayerParameter:
    """InnerProductLayer (reference: Layers.scala:88-100)."""
    ip: dict[str, Any] = {"num_output": num_output}
    if weight_filler:
        ip["weight_filler"] = weight_filler
    if bias_filler:
        ip["bias_filler"] = bias_filler
    return layer(name, "InnerProduct", [bottom], [top], param=param,
                 inner_product_param=ip)


def relu_layer(name: str, bottom: str, top: str | None = None) -> LayerParameter:
    """ReLULayer, in-place by default (reference: Layers.scala:102-113)."""
    return layer(name, "ReLU", [bottom], [top or bottom])


def lrn_layer(name: str, bottom: str, top: str, *, local_size: int = 5,
              alpha: float = 1.0, beta: float = 0.75) -> LayerParameter:
    return layer(name, "LRN", [bottom], [top], lrn_param={
        "local_size": local_size, "alpha": alpha, "beta": beta})


def dropout_layer(name: str, bottom: str, top: str | None = None,
                  ratio: float = 0.5) -> LayerParameter:
    return layer(name, "Dropout", [bottom], [top or bottom],
                 dropout_param={"dropout_ratio": ratio})


def softmax_layer(name: str, bottom: str, top: str) -> LayerParameter:
    return layer(name, "Softmax", [bottom], [top])


def softmax_with_loss_layer(name: str, bottoms: Sequence[str],
                            top: str = "loss") -> LayerParameter:
    """SoftmaxWithLoss (reference: Layers.scala:115-128)."""
    return layer(name, "SoftmaxWithLoss", bottoms, [top])


def accuracy_layer(name: str, bottoms: Sequence[str], top: str = "accuracy",
                   top_k: int = 1, phase: Phase | None = Phase.TEST) -> LayerParameter:
    ap = {"top_k": top_k} if top_k != 1 else {}
    return layer(name, "Accuracy", bottoms, [top], phase=phase,
                 accuracy_param=ap)
