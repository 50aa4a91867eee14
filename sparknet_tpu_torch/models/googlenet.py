"""GoogLeNet (Inception v1) — the deep fan-out stress model.

Architecture per the reference zoo (reference:
caffe/models/bvlc_googlenet/train_val.prototxt; published top-1 68.7%,
readme.md:19-20; fwd/bwd baseline 562.8/1123.8 ms @ batch 128 on K40+cuDNN,
readme.md:24-27).  Inception fan-out exercises what the reference needed
``InsertSplits`` for (caffe/src/caffe/util/insert_splits.cpp) — here value
reuse in the functional graph handles it.

Includes the two auxiliary classifiers (loss1/loss2, weight 0.3) attached
after inception_4a and 4d, train-phase only.
"""

from __future__ import annotations

from ..proto.caffe_pb import LayerParameter, NetParameter, Phase
from .dsl import (
    accuracy_layer, concat_layer, convolution_layer, dropout_layer,
    inner_product_layer, java_data_layer, layer, lrn_layer, net_param,
    pooling_layer, relu_layer, softmax_with_loss_layer,
)

_LRB = [{"lr_mult": 1.0, "decay_mult": 1.0}, {"lr_mult": 2.0, "decay_mult": 0.0}]
_XAVIER = {"type": "xavier"}
_B02 = {"type": "constant", "value": 0.2}


def _conv_relu(name: str, bottom: str, num_output: int, kernel: int,
               pad: int = 0, stride: int = 1) -> list[LayerParameter]:
    return [
        convolution_layer(name, bottom, name, num_output=num_output,
                          kernel=kernel, pad=pad, stride=stride,
                          weight_filler=_XAVIER, bias_filler=_B02, param=_LRB),
        relu_layer(f"{name}/relu", name),
    ]


def _inception(name: str, bottom: str, n1x1: int, n3x3r: int, n3x3: int,
               n5x5r: int, n5x5: int, npool: int) -> list[LayerParameter]:
    p = f"inception_{name}"
    layers: list[LayerParameter] = []
    layers += _conv_relu(f"{p}/1x1", bottom, n1x1, 1)
    layers += _conv_relu(f"{p}/3x3_reduce", bottom, n3x3r, 1)
    layers += _conv_relu(f"{p}/3x3", f"{p}/3x3_reduce", n3x3, 3, pad=1)
    layers += _conv_relu(f"{p}/5x5_reduce", bottom, n5x5r, 1)
    layers += _conv_relu(f"{p}/5x5", f"{p}/5x5_reduce", n5x5, 5, pad=2)
    layers.append(pooling_layer(f"{p}/pool", bottom, f"{p}/pool", pool="MAX",
                                kernel=3, stride=1, pad=1))
    layers += _conv_relu(f"{p}/pool_proj", f"{p}/pool", npool, 1)
    layers.append(concat_layer(f"{p}/output",
                               [f"{p}/1x1", f"{p}/3x3", f"{p}/5x5", f"{p}/pool_proj"],
                               f"{p}/output"))
    return layers


def _aux_classifier(tag: str, bottom: str) -> list[LayerParameter]:
    """Train-only auxiliary head, loss_weight 0.3."""
    p = f"loss{tag}"
    head = [
        pooling_layer(f"{p}/ave_pool", bottom, f"{p}/ave_pool", pool="AVE",
                      kernel=5, stride=3),
        *_conv_relu(f"{p}/conv", f"{p}/ave_pool", 128, 1),
        inner_product_layer(f"{p}/fc", f"{p}/conv", f"{p}/fc", num_output=1024,
                            weight_filler=_XAVIER, bias_filler=_B02, param=_LRB),
        relu_layer(f"{p}/relu_fc", f"{p}/fc"),
        dropout_layer(f"{p}/drop_fc", f"{p}/fc", ratio=0.7),
        inner_product_layer(f"{p}/classifier", f"{p}/fc", f"{p}/classifier",
                            num_output=1000, weight_filler=_XAVIER,
                            bias_filler={"type": "constant"}, param=_LRB),
    ]
    loss = layer(f"{p}/loss", "SoftmaxWithLoss",
                 [f"{p}/classifier", "label"], [f"{p}/loss1"],
                 phase=Phase.TRAIN)
    loss.loss_weight = [0.3]
    for l in head:
        l.phase = Phase.TRAIN
    return head + [loss]


def googlenet(train_batch: int = 32, test_batch: int = 50,
              crop: int = 224) -> NetParameter:
    layers: list[LayerParameter] = [
        java_data_layer("data_train", ["data", "label"], Phase.TRAIN,
                        (train_batch, 3, crop, crop), (train_batch,)),
        java_data_layer("data_test", ["data", "label"], Phase.TEST,
                        (test_batch, 3, crop, crop), (test_batch,)),
        *_conv_relu("conv1/7x7_s2", "data", 64, 7, pad=3, stride=2),
        pooling_layer("pool1/3x3_s2", "conv1/7x7_s2", "pool1/3x3_s2",
                      pool="MAX", kernel=3, stride=2),
        lrn_layer("pool1/norm1", "pool1/3x3_s2", "pool1/norm1",
                  local_size=5, alpha=1e-4, beta=0.75),
        *_conv_relu("conv2/3x3_reduce", "pool1/norm1", 64, 1),
        *_conv_relu("conv2/3x3", "conv2/3x3_reduce", 192, 3, pad=1),
        lrn_layer("conv2/norm2", "conv2/3x3", "conv2/norm2",
                  local_size=5, alpha=1e-4, beta=0.75),
        pooling_layer("pool2/3x3_s2", "conv2/norm2", "pool2/3x3_s2",
                      pool="MAX", kernel=3, stride=2),
        *_inception("3a", "pool2/3x3_s2", 64, 96, 128, 16, 32, 32),
        *_inception("3b", "inception_3a/output", 128, 128, 192, 32, 96, 64),
        pooling_layer("pool3/3x3_s2", "inception_3b/output", "pool3/3x3_s2",
                      pool="MAX", kernel=3, stride=2),
        *_inception("4a", "pool3/3x3_s2", 192, 96, 208, 16, 48, 64),
        *_aux_classifier("1", "inception_4a/output"),
        *_inception("4b", "inception_4a/output", 160, 112, 224, 24, 64, 64),
        *_inception("4c", "inception_4b/output", 128, 128, 256, 24, 64, 64),
        *_inception("4d", "inception_4c/output", 112, 144, 288, 32, 64, 64),
        *_aux_classifier("2", "inception_4d/output"),
        *_inception("4e", "inception_4d/output", 256, 160, 320, 32, 128, 128),
        pooling_layer("pool4/3x3_s2", "inception_4e/output", "pool4/3x3_s2",
                      pool="MAX", kernel=3, stride=2),
        *_inception("5a", "pool4/3x3_s2", 256, 160, 320, 32, 128, 128),
        *_inception("5b", "inception_5a/output", 384, 192, 384, 48, 128, 128),
        pooling_layer("pool5/7x7_s1", "inception_5b/output", "pool5/7x7_s1",
                      pool="AVE", kernel=7, stride=1),
        dropout_layer("pool5/drop_7x7_s1", "pool5/7x7_s1", ratio=0.4),
        inner_product_layer("loss3/classifier", "pool5/7x7_s1",
                            "loss3/classifier", num_output=1000,
                            weight_filler=_XAVIER,
                            bias_filler={"type": "constant"}, param=_LRB),
        softmax_with_loss_layer("loss3/loss3", ["loss3/classifier", "label"],
                                top="loss3/loss3"),
        accuracy_layer("loss3/top-1", ["loss3/classifier", "label"],
                       top="loss3/top-1", phase=Phase.TEST),
        accuracy_layer("loss3/top-5", ["loss3/classifier", "label"],
                       top="loss3/top-5", top_k=5, phase=Phase.TEST),
    ]
    return net_param("GoogleNet", layers)
