"""LeNet on MNIST — the minimal zoo model.

Architecture per the reference zoo's lenet_train_test config
(reference: caffe/examples/mnist/lenet_train_test.prototxt), built with the
DSL the way LayerSpec builds its Scala-DSL LeNet (reference:
src/test/scala/libs/LayerSpec.scala).
"""

from __future__ import annotations

from ..proto.caffe_pb import NetParameter, Phase
from .dsl import (
    accuracy_layer, convolution_layer, inner_product_layer, java_data_layer,
    net_param, pooling_layer, relu_layer, softmax_with_loss_layer,
)

_XAVIER = {"type": "xavier"}
_ZERO = {"type": "constant"}
_LRB = [{"lr_mult": 1.0}, {"lr_mult": 2.0}]


def lenet(train_batch: int = 64, test_batch: int = 100,
          image: tuple[int, int, int] = (1, 28, 28)) -> NetParameter:
    c, h, w = image
    return net_param("LeNet", [
        java_data_layer("mnist_train", ["data", "label"], Phase.TRAIN,
                        (train_batch, c, h, w), (train_batch,)),
        java_data_layer("mnist_test", ["data", "label"], Phase.TEST,
                        (test_batch, c, h, w), (test_batch,)),
        convolution_layer("conv1", "data", "conv1", num_output=20, kernel=5,
                          weight_filler=_XAVIER, bias_filler=_ZERO, param=_LRB),
        pooling_layer("pool1", "conv1", "pool1", pool="MAX", kernel=2, stride=2),
        convolution_layer("conv2", "pool1", "conv2", num_output=50, kernel=5,
                          weight_filler=_XAVIER, bias_filler=_ZERO, param=_LRB),
        pooling_layer("pool2", "conv2", "pool2", pool="MAX", kernel=2, stride=2),
        inner_product_layer("ip1", "pool2", "ip1", num_output=500,
                            weight_filler=_XAVIER, bias_filler=_ZERO, param=_LRB),
        relu_layer("relu1", "ip1"),
        inner_product_layer("ip2", "ip1", "ip2", num_output=10,
                            weight_filler=_XAVIER, bias_filler=_ZERO, param=_LRB),
        softmax_with_loss_layer("loss", ["ip2", "label"]),
        accuracy_layer("accuracy", ["ip2", "label"], phase=Phase.TEST),
    ])
