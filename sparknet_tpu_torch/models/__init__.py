from .dsl import (
    net_param,
    java_data_layer,
    convolution_layer,
    pooling_layer,
    inner_product_layer,
    relu_layer,
    lrn_layer,
    dropout_layer,
    softmax_layer,
    softmax_with_loss_layer,
    accuracy_layer,
    layer,
    msg,
)
from .lenet import lenet
from .alexnet import alexnet, caffenet
