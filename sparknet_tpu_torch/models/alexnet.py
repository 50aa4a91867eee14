"""AlexNet / CaffeNet — the ImageNetApp flagship models.

Architectures per the reference zoo (reference:
caffe/models/bvlc_alexnet/train_val.prototxt and
caffe/models/bvlc_reference_caffenet/train_val.prototxt; published top-1
57.1%/57.4% — caffe/models/bvlc_alexnet/readme.md:15-18,
bvlc_reference_caffenet/readme.md:16-18).  CaffeNet differs from AlexNet
only in the relu→pool→norm ordering of the first two stages (pooling before
normalization).  This is the model ImageNetApp trains with τ=50 parameter
averaging (reference: src/main/scala/apps/ImageNetApp.scala:144).
"""

from __future__ import annotations

from ..proto.caffe_pb import NetParameter, Phase
from .dsl import (
    accuracy_layer, convolution_layer, dropout_layer, inner_product_layer,
    java_data_layer, lrn_layer, net_param, pooling_layer, relu_layer,
    softmax_with_loss_layer,
)

_LRB = [{"lr_mult": 1.0, "decay_mult": 1.0}, {"lr_mult": 2.0, "decay_mult": 0.0}]


def _g(std: float, bias: float = 0.0):
    return {"type": "gaussian", "std": std}, {"type": "constant", "value": bias}


def _backbone(order_norm_first: bool) -> list:
    """Shared conv stack; order_norm_first=True gives AlexNet's
    relu→norm→pool, False gives CaffeNet's relu→pool→norm."""
    w1, b1 = _g(0.01, 0.0)
    w2, b2 = _g(0.01, 1.0 if not order_norm_first else 0.1)
    layers = [
        convolution_layer("conv1", "data", "conv1", num_output=96, kernel=11,
                          stride=4, weight_filler=w1, bias_filler=b1, param=_LRB),
        relu_layer("relu1", "conv1"),
    ]
    if order_norm_first:
        layers += [
            lrn_layer("norm1", "conv1", "norm1", local_size=5, alpha=1e-4, beta=0.75),
            pooling_layer("pool1", "norm1", "pool1", pool="MAX", kernel=3, stride=2),
        ]
        stage2_in = "pool1"
    else:
        layers += [
            pooling_layer("pool1", "conv1", "pool1", pool="MAX", kernel=3, stride=2),
            lrn_layer("norm1", "pool1", "norm1", local_size=5, alpha=1e-4, beta=0.75),
        ]
        stage2_in = "norm1"
    layers += [
        convolution_layer("conv2", stage2_in, "conv2", num_output=256, kernel=5,
                          pad=2, group=2, weight_filler=w2, bias_filler=b2,
                          param=_LRB),
        relu_layer("relu2", "conv2"),
    ]
    if order_norm_first:
        layers += [
            lrn_layer("norm2", "conv2", "norm2", local_size=5, alpha=1e-4, beta=0.75),
            pooling_layer("pool2", "norm2", "pool2", pool="MAX", kernel=3, stride=2),
        ]
        stage3_in = "pool2"
    else:
        layers += [
            pooling_layer("pool2", "conv2", "pool2", pool="MAX", kernel=3, stride=2),
            lrn_layer("norm2", "pool2", "norm2", local_size=5, alpha=1e-4, beta=0.75),
        ]
        stage3_in = "norm2"
    w3, b3 = _g(0.01, 0.0)
    w45, b45 = _g(0.01, 1.0 if not order_norm_first else 0.1)
    layers += [
        convolution_layer("conv3", stage3_in, "conv3", num_output=384, kernel=3,
                          pad=1, weight_filler=w3, bias_filler=b3, param=_LRB),
        relu_layer("relu3", "conv3"),
        convolution_layer("conv4", "conv3", "conv4", num_output=384, kernel=3,
                          pad=1, group=2, weight_filler=w45, bias_filler=b45,
                          param=_LRB),
        relu_layer("relu4", "conv4"),
        convolution_layer("conv5", "conv4", "conv5", num_output=256, kernel=3,
                          pad=1, group=2, weight_filler=w45, bias_filler=b45,
                          param=_LRB),
        relu_layer("relu5", "conv5"),
        pooling_layer("pool5", "conv5", "pool5", pool="MAX", kernel=3, stride=2),
    ]
    wf, bf = _g(0.005, 1.0 if not order_norm_first else 0.1)
    w8, b8 = _g(0.01, 0.0)
    layers += [
        inner_product_layer("fc6", "pool5", "fc6", num_output=4096,
                            weight_filler=wf, bias_filler=bf, param=_LRB),
        relu_layer("relu6", "fc6"),
        dropout_layer("drop6", "fc6", ratio=0.5),
        inner_product_layer("fc7", "fc6", "fc7", num_output=4096,
                            weight_filler=wf, bias_filler=bf, param=_LRB),
        relu_layer("relu7", "fc7"),
        dropout_layer("drop7", "fc7", ratio=0.5),
        inner_product_layer("fc8", "fc7", "fc8", num_output=1000,
                            weight_filler=w8, bias_filler=b8, param=_LRB),
        softmax_with_loss_layer("loss", ["fc8", "label"]),
        accuracy_layer("accuracy", ["fc8", "label"], phase=Phase.TEST),
    ]
    return layers


def _net(name: str, norm_first: bool, train_batch: int, test_batch: int,
         crop: int) -> NetParameter:
    data = [
        java_data_layer("data_train", ["data", "label"], Phase.TRAIN,
                        (train_batch, 3, crop, crop), (train_batch,)),
        java_data_layer("data_test", ["data", "label"], Phase.TEST,
                        (test_batch, 3, crop, crop), (test_batch,)),
    ]
    return net_param(name, data + _backbone(norm_first))


def alexnet(train_batch: int = 256, test_batch: int = 50,
            crop: int = 227) -> NetParameter:
    return _net("AlexNet", True, train_batch, test_batch, crop)


def caffenet(train_batch: int = 256, test_batch: int = 50,
             crop: int = 227) -> NetParameter:
    return _net("CaffeNet", False, train_batch, test_batch, crop)
