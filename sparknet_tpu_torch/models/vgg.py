"""VGG-16 — the zoo's largest model (138M params).

Architecture per the public VGG ILSVRC 16-layer config; the reference zoo
carries the same family for its multi-GPU scaling docs (reference:
caffe/docs/multigpu.md).  The port's own copy of
``sparknet_tpu/models/vgg.py``."""

from __future__ import annotations

from ..proto.caffe_pb import LayerParameter, NetParameter, Phase
from .dsl import (
    accuracy_layer, convolution_layer, dropout_layer, inner_product_layer,
    java_data_layer, net_param, pooling_layer, relu_layer,
    softmax_with_loss_layer,
)

_LRB = [{"lr_mult": 1.0, "decay_mult": 1.0}, {"lr_mult": 2.0, "decay_mult": 0.0}]
_W = {"type": "gaussian", "std": 0.01}
_B = {"type": "constant"}

_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def vgg16(train_batch: int = 64, test_batch: int = 50,
          crop: int = 224) -> NetParameter:
    layers: list[LayerParameter] = [
        java_data_layer("data_train", ["data", "label"], Phase.TRAIN,
                        (train_batch, 3, crop, crop), (train_batch,)),
        java_data_layer("data_test", ["data", "label"], Phase.TEST,
                        (test_batch, 3, crop, crop), (test_batch,)),
    ]
    bottom = "data"
    for si, (width, reps) in enumerate(_STAGES, start=1):
        for ri in range(1, reps + 1):
            name = f"conv{si}_{ri}"
            layers.append(convolution_layer(
                name, bottom, name, num_output=width, kernel=3, pad=1,
                weight_filler=_W, bias_filler=_B, param=_LRB))
            layers.append(relu_layer(f"relu{si}_{ri}", name))
            bottom = name
        layers.append(pooling_layer(f"pool{si}", bottom, f"pool{si}",
                                    pool="MAX", kernel=2, stride=2))
        bottom = f"pool{si}"
    for i, width in ((6, 4096), (7, 4096)):
        layers += [
            inner_product_layer(f"fc{i}", bottom, f"fc{i}", num_output=width,
                                weight_filler={"type": "gaussian", "std": 0.005},
                                bias_filler={"type": "constant", "value": 0.1},
                                param=_LRB),
            relu_layer(f"relu{i}", f"fc{i}"),
            dropout_layer(f"drop{i}", f"fc{i}", ratio=0.5),
        ]
        bottom = f"fc{i}"
    layers += [
        inner_product_layer("fc8", bottom, "fc8", num_output=1000,
                            weight_filler=_W, bias_filler=_B, param=_LRB),
        softmax_with_loss_layer("loss", ["fc8", "label"]),
        accuracy_layer("accuracy", ["fc8", "label"], phase=Phase.TEST),
        accuracy_layer("accuracy_top5", ["fc8", "label"], top="accuracy_top5",
                       top_k=5, phase=Phase.TEST),
    ]
    return net_param("VGG_ILSVRC_16", layers)
