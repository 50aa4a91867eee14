"""CIFAR-10 zoo models: cifar10_quick and cifar10_full.

Architectures per the reference zoo (reference:
caffe/examples/cifar10/cifar10_quick_train_test.prototxt and
cifar10_full_train_test.prototxt; the full model's published accuracy is
~75%, caffe/examples/cifar10/readme.md:81).  These are the nets CifarApp
trains (reference: src/main/scala/apps/CifarApp.scala:62-66).
"""

from __future__ import annotations

from ..proto.caffe_pb import NetParameter, Phase
from .dsl import (
    accuracy_layer, convolution_layer, inner_product_layer, java_data_layer,
    layer, net_param, pooling_layer, relu_layer, softmax_with_loss_layer,
)

_LRB = [{"lr_mult": 1.0}, {"lr_mult": 2.0}]


def _data(train_batch: int, test_batch: int):
    return [
        java_data_layer("cifar_train", ["data", "label"], Phase.TRAIN,
                        (train_batch, 3, 32, 32), (train_batch,)),
        java_data_layer("cifar_test", ["data", "label"], Phase.TEST,
                        (test_batch, 3, 32, 32), (test_batch,)),
    ]


def cifar10_quick(train_batch: int = 100, test_batch: int = 100) -> NetParameter:
    g = lambda std: {"type": "gaussian", "std": std}
    zero = {"type": "constant"}
    return net_param("CIFAR10_quick", _data(train_batch, test_batch) + [
        convolution_layer("conv1", "data", "conv1", num_output=32, kernel=5,
                          pad=2, weight_filler=g(0.0001), bias_filler=zero,
                          param=_LRB),
        pooling_layer("pool1", "conv1", "pool1", pool="MAX", kernel=3, stride=2),
        relu_layer("relu1", "pool1"),
        convolution_layer("conv2", "pool1", "conv2", num_output=32, kernel=5,
                          pad=2, weight_filler=g(0.01), bias_filler=zero,
                          param=_LRB),
        relu_layer("relu2", "conv2"),
        pooling_layer("pool2", "conv2", "pool2", pool="AVE", kernel=3, stride=2),
        convolution_layer("conv3", "pool2", "conv3", num_output=64, kernel=5,
                          pad=2, weight_filler=g(0.01), bias_filler=zero,
                          param=_LRB),
        relu_layer("relu3", "conv3"),
        pooling_layer("pool3", "conv3", "pool3", pool="AVE", kernel=3, stride=2),
        inner_product_layer("ip1", "pool3", "ip1", num_output=64,
                            weight_filler=g(0.1), bias_filler=zero, param=_LRB),
        inner_product_layer("ip2", "ip1", "ip2", num_output=10,
                            weight_filler=g(0.1), bias_filler=zero, param=_LRB),
        softmax_with_loss_layer("loss", ["ip2", "label"]),
        accuracy_layer("accuracy", ["ip2", "label"], phase=Phase.TEST),
    ])


def cifar10_full(train_batch: int = 100, test_batch: int = 100) -> NetParameter:
    g = lambda std: {"type": "gaussian", "std": std}
    zero = {"type": "constant"}

    def lrn_within(name: str, bottom: str, top: str):
        return layer(name, "LRN", [bottom], [top], lrn_param={
            "local_size": 3, "alpha": 5e-05, "beta": 0.75,
            "norm_region": "WITHIN_CHANNEL"})

    return net_param("CIFAR10_full", _data(train_batch, test_batch) + [
        convolution_layer("conv1", "data", "conv1", num_output=32, kernel=5,
                          pad=2, weight_filler=g(0.0001), bias_filler=zero,
                          param=_LRB),
        pooling_layer("pool1", "conv1", "pool1", pool="MAX", kernel=3, stride=2),
        relu_layer("relu1", "pool1"),
        lrn_within("norm1", "pool1", "norm1"),
        convolution_layer("conv2", "norm1", "conv2", num_output=32, kernel=5,
                          pad=2, weight_filler=g(0.01), bias_filler=zero,
                          param=_LRB),
        relu_layer("relu2", "conv2"),
        pooling_layer("pool2", "conv2", "pool2", pool="AVE", kernel=3, stride=2),
        lrn_within("norm2", "pool2", "norm2"),
        convolution_layer("conv3", "norm2", "conv3", num_output=64, kernel=5,
                          pad=2, weight_filler=g(0.01), bias_filler=zero,
                          param=_LRB),
        relu_layer("relu3", "conv3"),
        pooling_layer("pool3", "conv3", "pool3", pool="AVE", kernel=3, stride=2),
        inner_product_layer("ip1", "pool3", "ip1", num_output=10,
                            weight_filler=g(0.01), bias_filler=zero,
                            param=[{"lr_mult": 1.0, "decay_mult": 250.0},
                                   {"lr_mult": 2.0, "decay_mult": 0.0}]),
        softmax_with_loss_layer("loss", ["ip1", "label"]),
        accuracy_layer("accuracy", ["ip1", "label"], phase=Phase.TEST),
    ])
