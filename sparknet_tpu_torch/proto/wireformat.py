"""Protobuf *wire-format* (binary) codec for the Caffe schema, schema-tabled.

The port's own copy of ``sparknet_tpu/proto/wireformat.py`` (the whole
``MESSAGES``/``ENUMS`` schema, ``decode`` and ``encode``), pure Python and
numpy.  The reference moves every persistent artifact as binary protobuf:
``.caffemodel`` weight snapshots (reference: caffe/src/caffe/net.cpp:805-848
``CopyTrainedLayersFromBinaryProto`` / ``WriteProtoToBinaryFile``),
``.solverstate`` solver snapshots (caffe/src/caffe/solver.cpp:447-530,
sgd_solver.cpp:242-296) and ``mean.binaryproto`` mean images
(util/io.cpp ReadProtoFromBinaryFile).  Binary and text decode into the
same ``PMessage`` multimap, so every typed view in ``caffe_pb`` works on
both.

Design notes:
- ``MESSAGES`` maps message name -> {field number: (field name, kind)}.
  Field numbers transcribed from caffe/src/caffe/proto/caffe.proto (cited
  per message below).  Unknown field numbers are skipped on decode (proto2
  forward compatibility); unknown field *names* raise on encode.
- Large numeric blobs (``BlobProto.data``/``diff``) use the ``pfloat32``
  family: a packed record decodes to one numpy array that is a read-only
  view of the input bytes (``np.frombuffer``, no copy: a CaffeNet file
  holds 61 million floats), and encoders emit a single packed record.
  Packed and unpacked encodings are both accepted on decode, as protobuf
  >= 2.3 parsers do.
- Enum values decode to their identifier strings ("MAX", "TRAIN", ...),
  matching what the text-format parser produces.
"""

from __future__ import annotations

import struct

import numpy as np

from .textformat import EnumToken, PMessage

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

# ---------------------------------------------------------------------------
# Enum tables (caffe.proto; value -> identifier)
# ---------------------------------------------------------------------------

ENUMS: dict[str, dict[int, str]] = {
    # caffe.proto:252-255
    "Phase": {0: "TRAIN", 1: "TEST"},
    # caffe.proto:56-60
    "VarianceNorm": {0: "FAN_IN", 1: "FAN_OUT", 2: "AVERAGE"},
    # caffe.proto:194-197
    "SnapshotFormat": {0: "HDF5", 1: "BINARYPROTO"},
    # caffe.proto:200-203
    "SolverMode": {0: "CPU", 1: "GPU"},
    # caffe.proto:232-239
    "SolverType": {0: "SGD", 1: "NESTEROV", 2: "ADAGRAD", 3: "RMSPROP",
                   4: "ADADELTA", 5: "ADAM"},
    # caffe.proto:292-297
    "DimCheckMode": {0: "STRICT", 1: "PERMISSIVE"},
    # caffe.proto:775-779
    "PoolMethod": {0: "MAX", 1: "AVE", 2: "STOCHASTIC"},
    # caffe.proto:518-522 (Engine enums are identical across layers)
    "Engine": {0: "DEFAULT", 1: "CAFFE", 2: "CUDNN"},
    # caffe.proto:545-548
    "DB": {0: "LEVELDB", 1: "LMDB"},
    # caffe.proto:602-606
    "EltwiseOp": {0: "PROD", 1: "SUM", 2: "MAX"},
    # caffe.proto:742-745
    "NormRegion": {0: "ACROSS_CHANNELS", 1: "WITHIN_CHANNEL"},
    # caffe.proto:671-675
    "HingeNorm": {1: "L1", 2: "L2"},
    # caffe.proto:826-831
    "ReductionOp": {1: "SUM", 2: "ASUM", 3: "SUMSQ", 4: "MEAN"},
    # V1LayerParameter.LayerType, caffe.proto:1051-1092
    "V1LayerType": {
        0: "NONE", 35: "ABSVAL", 1: "ACCURACY", 30: "ARGMAX", 2: "BNLL",
        3: "CONCAT", 37: "CONTRASTIVE_LOSS", 4: "CONVOLUTION", 5: "DATA",
        39: "DECONVOLUTION", 6: "DROPOUT", 32: "DUMMY_DATA",
        7: "EUCLIDEAN_LOSS", 25: "ELTWISE", 38: "EXP", 8: "FLATTEN",
        9: "HDF5_DATA", 10: "HDF5_OUTPUT", 28: "HINGE_LOSS", 11: "IM2COL",
        12: "IMAGE_DATA", 13: "INFOGAIN_LOSS", 14: "INNER_PRODUCT",
        15: "LRN", 29: "MEMORY_DATA", 16: "MULTINOMIAL_LOGISTIC_LOSS",
        34: "MVN", 17: "POOLING", 26: "POWER", 18: "RELU", 19: "SIGMOID",
        27: "SIGMOID_CROSS_ENTROPY_LOSS", 36: "SILENCE", 20: "SOFTMAX",
        21: "SOFTMAX_LOSS", 22: "SPLIT", 33: "SLICE", 23: "TANH",
        24: "WINDOW_DATA", 31: "THRESHOLD",
    },
}

_ENUM_REV: dict[str, dict[str, int]] = {
    name: {v: k for k, v in table.items()} for name, table in ENUMS.items()
}

# ---------------------------------------------------------------------------
# Message schema: name -> {field number: (field name, kind)}
# Kinds: int32 int64 uint32 uint64 bool float double string bytes
#        pfloat32 pfloat64 pint64 (packed numpy vectors)
#        msg:<Message> enum:<Enum>
# ---------------------------------------------------------------------------

_FILLER = {  # caffe.proto:43-62
    1: ("type", "string"), 2: ("value", "float"), 3: ("min", "float"),
    4: ("max", "float"), 5: ("mean", "float"), 6: ("std", "float"),
    7: ("sparse", "int32"), 8: ("variance_norm", "enum:VarianceNorm"),
}

MESSAGES: dict[str, dict[int, tuple[str, str]]] = {
    # caffe.proto:6-8
    "BlobShape": {1: ("dim", "pint64")},
    # caffe.proto:10-24
    "BlobProto": {
        7: ("shape", "msg:BlobShape"),
        5: ("data", "pfloat32"), 6: ("diff", "pfloat32"),
        8: ("double_data", "pfloat64"), 9: ("double_diff", "pfloat64"),
        1: ("num", "int32"), 2: ("channels", "int32"),
        3: ("height", "int32"), 4: ("width", "int32"),
    },
    # caffe.proto:26-28
    "BlobProtoVector": {1: ("blobs", "msg:BlobProto")},
    # caffe.proto:30-41
    "Datum": {
        1: ("channels", "int32"), 2: ("height", "int32"),
        3: ("width", "int32"), 4: ("data", "bytes"), 5: ("label", "int32"),
        6: ("float_data", "float"), 7: ("encoded", "bool"),
    },
    "FillerParameter": _FILLER,
    # caffe.proto:64-100
    "NetParameter": {
        1: ("name", "string"), 3: ("input", "string"),
        8: ("input_shape", "msg:BlobShape"), 4: ("input_dim", "int32"),
        5: ("force_backward", "bool"), 6: ("state", "msg:NetState"),
        7: ("debug_info", "bool"), 100: ("layer", "msg:LayerParameter"),
        2: ("layers", "msg:V1LayerParameter"),
    },
    # caffe.proto:102-243
    "SolverParameter": {
        24: ("net", "string"), 25: ("net_param", "msg:NetParameter"),
        1: ("train_net", "string"), 2: ("test_net", "string"),
        21: ("train_net_param", "msg:NetParameter"),
        22: ("test_net_param", "msg:NetParameter"),
        26: ("train_state", "msg:NetState"),
        27: ("test_state", "msg:NetState"),
        3: ("test_iter", "int32"), 4: ("test_interval", "int32"),
        19: ("test_compute_loss", "bool"),
        32: ("test_initialization", "bool"), 5: ("base_lr", "float"),
        6: ("display", "int32"), 33: ("average_loss", "int32"),
        7: ("max_iter", "int32"), 36: ("iter_size", "int32"),
        8: ("lr_policy", "string"), 9: ("gamma", "float"),
        10: ("power", "float"), 11: ("momentum", "float"),
        12: ("weight_decay", "float"),
        29: ("regularization_type", "string"), 13: ("stepsize", "int32"),
        34: ("stepvalue", "int32"), 35: ("clip_gradients", "float"),
        14: ("snapshot", "int32"), 15: ("snapshot_prefix", "string"),
        16: ("snapshot_diff", "bool"),
        37: ("snapshot_format", "enum:SnapshotFormat"),
        17: ("solver_mode", "enum:SolverMode"), 18: ("device_id", "int32"),
        20: ("random_seed", "int64"), 40: ("type", "string"),
        31: ("delta", "float"), 39: ("momentum2", "float"),
        38: ("rms_decay", "float"), 23: ("debug_info", "bool"),
        28: ("snapshot_after_train", "bool"),
        30: ("solver_type", "enum:SolverType"),
    },
    # caffe.proto:245-250
    "SolverState": {
        1: ("iter", "int32"), 2: ("learned_net", "string"),
        3: ("history", "msg:BlobProto"), 4: ("current_step", "int32"),
    },
    # caffe.proto:257-261
    "NetState": {
        1: ("phase", "enum:Phase"), 2: ("level", "int32"),
        3: ("stage", "string"),
    },
    # caffe.proto:263-281
    "NetStateRule": {
        1: ("phase", "enum:Phase"), 2: ("min_level", "int32"),
        3: ("max_level", "int32"), 4: ("stage", "string"),
        5: ("not_stage", "string"),
    },
    # caffe.proto:283-307
    "ParamSpec": {
        1: ("name", "string"), 2: ("share_mode", "enum:DimCheckMode"),
        3: ("lr_mult", "float"), 4: ("decay_mult", "float"),
    },
    # caffe.proto:310-396
    "LayerParameter": {
        1: ("name", "string"), 2: ("type", "string"),
        3: ("bottom", "string"), 4: ("top", "string"),
        10: ("phase", "enum:Phase"), 5: ("loss_weight", "float"),
        6: ("param", "msg:ParamSpec"), 7: ("blobs", "msg:BlobProto"),
        11: ("propagate_down", "bool"),
        8: ("include", "msg:NetStateRule"),
        9: ("exclude", "msg:NetStateRule"),
        100: ("transform_param", "msg:TransformationParameter"),
        101: ("loss_param", "msg:LossParameter"),
        102: ("accuracy_param", "msg:AccuracyParameter"),
        103: ("argmax_param", "msg:ArgMaxParameter"),
        139: ("batch_norm_param", "msg:BatchNormParameter"),
        104: ("concat_param", "msg:ConcatParameter"),
        105: ("contrastive_loss_param", "msg:ContrastiveLossParameter"),
        106: ("convolution_param", "msg:ConvolutionParameter"),
        107: ("data_param", "msg:DataParameter"),
        108: ("dropout_param", "msg:DropoutParameter"),
        109: ("dummy_data_param", "msg:DummyDataParameter"),
        110: ("eltwise_param", "msg:EltwiseParameter"),
        137: ("embed_param", "msg:EmbedParameter"),
        111: ("exp_param", "msg:ExpParameter"),
        135: ("flatten_param", "msg:FlattenParameter"),
        112: ("hdf5_data_param", "msg:HDF5DataParameter"),
        113: ("hdf5_output_param", "msg:HDF5OutputParameter"),
        114: ("hinge_loss_param", "msg:HingeLossParameter"),
        115: ("image_data_param", "msg:ImageDataParameter"),
        116: ("infogain_loss_param", "msg:InfogainLossParameter"),
        117: ("inner_product_param", "msg:InnerProductParameter"),
        134: ("log_param", "msg:LogParameter"),
        118: ("lrn_param", "msg:LRNParameter"),
        119: ("memory_data_param", "msg:MemoryDataParameter"),
        120: ("mvn_param", "msg:MVNParameter"),
        121: ("pooling_param", "msg:PoolingParameter"),
        122: ("power_param", "msg:PowerParameter"),
        131: ("prelu_param", "msg:PReLUParameter"),
        130: ("python_param", "msg:PythonParameter"),
        136: ("reduction_param", "msg:ReductionParameter"),
        123: ("relu_param", "msg:ReLUParameter"),
        133: ("reshape_param", "msg:ReshapeParameter"),
        124: ("sigmoid_param", "msg:SigmoidParameter"),
        125: ("softmax_param", "msg:SoftmaxParameter"),
        132: ("spp_param", "msg:SPPParameter"),
        126: ("slice_param", "msg:SliceParameter"),
        127: ("tanh_param", "msg:TanHParameter"),
        128: ("threshold_param", "msg:ThresholdParameter"),
        138: ("tile_param", "msg:TileParameter"),
        149: ("java_data_param", "msg:JavaDataParameter"),
        129: ("window_data_param", "msg:WindowDataParameter"),
        # post-fork upstream additions the ops layer supports (field numbers
        # from BVLC caffe master caffe.proto; absent from the fork's schema
        # but required to round-trip Scale/Bias/Input-bearing nets)
        141: ("bias_param", "msg:BiasParameter"),
        142: ("scale_param", "msg:ScaleParameter"),
        143: ("input_param", "msg:InputParameter"),
    },
    # BVLC caffe master: InputParameter
    "InputParameter": {1: ("shape", "msg:BlobShape")},
    # BVLC caffe master: ScaleParameter
    "ScaleParameter": {
        1: ("axis", "int32"), 2: ("num_axes", "int32"),
        3: ("filler", "msg:FillerParameter"), 4: ("bias_term", "bool"),
        5: ("bias_filler", "msg:FillerParameter"),
    },
    # BVLC caffe master: BiasParameter
    "BiasParameter": {
        1: ("axis", "int32"), 2: ("num_axes", "int32"),
        3: ("filler", "msg:FillerParameter"),
    },
    # caffe.proto:399-418
    "TransformationParameter": {
        1: ("scale", "float"), 2: ("mirror", "bool"),
        3: ("crop_size", "uint32"), 4: ("mean_file", "string"),
        5: ("mean_value", "float"), 6: ("force_color", "bool"),
        7: ("force_gray", "bool"),
    },
    # caffe.proto:421-430
    "LossParameter": {1: ("ignore_label", "int32"), 2: ("normalize", "bool")},
    # caffe.proto:432-447
    "AccuracyParameter": {
        1: ("top_k", "uint32"), 2: ("axis", "int32"),
        3: ("ignore_label", "int32"),
    },
    # caffe.proto:449-458
    "ArgMaxParameter": {
        1: ("out_max_val", "bool"), 2: ("top_k", "uint32"),
        3: ("axis", "int32"),
    },
    # caffe.proto:460-469
    "ConcatParameter": {2: ("axis", "int32"), 1: ("concat_dim", "uint32")},
    # caffe.proto:471-481
    "BatchNormParameter": {
        1: ("use_global_stats", "bool"),
        2: ("moving_average_fraction", "float"), 3: ("eps", "float"),
    },
    # caffe.proto:483-493
    "ContrastiveLossParameter": {
        1: ("margin", "float"), 2: ("legacy_version", "bool"),
    },
    # caffe.proto:495-542
    "ConvolutionParameter": {
        1: ("num_output", "uint32"), 2: ("bias_term", "bool"),
        3: ("pad", "uint32"), 4: ("kernel_size", "uint32"),
        6: ("stride", "uint32"), 9: ("pad_h", "uint32"),
        10: ("pad_w", "uint32"), 11: ("kernel_h", "uint32"),
        12: ("kernel_w", "uint32"), 13: ("stride_h", "uint32"),
        14: ("stride_w", "uint32"), 5: ("group", "uint32"),
        7: ("weight_filler", "msg:FillerParameter"),
        8: ("bias_filler", "msg:FillerParameter"),
        15: ("engine", "enum:Engine"), 16: ("axis", "int32"),
        17: ("force_nd_im2col", "bool"),
    },
    # caffe.proto:544-576
    "DataParameter": {
        1: ("source", "string"), 4: ("batch_size", "uint32"),
        7: ("rand_skip", "uint32"), 8: ("backend", "enum:DB"),
        2: ("scale", "float"), 3: ("mean_file", "string"),
        5: ("crop_size", "uint32"), 6: ("mirror", "bool"),
        9: ("force_encoded_color", "bool"), 10: ("prefetch", "uint32"),
    },
    # caffe.proto:578-582
    "DropoutParameter": {1: ("dropout_ratio", "float")},
    # caffe.proto:584-599
    "DummyDataParameter": {
        1: ("data_filler", "msg:FillerParameter"),
        6: ("shape", "msg:BlobShape"), 2: ("num", "uint32"),
        3: ("channels", "uint32"), 4: ("height", "uint32"),
        5: ("width", "uint32"),
    },
    # caffe.proto:601-613
    "EltwiseParameter": {
        1: ("operation", "enum:EltwiseOp"), 2: ("coeff", "float"),
        3: ("stable_prod_grad", "bool"),
    },
    # caffe.proto:616-626
    "EmbedParameter": {
        1: ("num_output", "uint32"), 2: ("input_dim", "uint32"),
        3: ("bias_term", "bool"),
        4: ("weight_filler", "msg:FillerParameter"),
        5: ("bias_filler", "msg:FillerParameter"),
    },
    # caffe.proto:630-637
    "ExpParameter": {
        1: ("base", "float"), 2: ("scale", "float"), 3: ("shift", "float"),
    },
    # caffe.proto:640-649
    "FlattenParameter": {1: ("axis", "int32"), 2: ("end_axis", "int32")},
    # caffe.proto:652-664
    "HDF5DataParameter": {
        1: ("source", "string"), 2: ("batch_size", "uint32"),
        3: ("shuffle", "bool"),
    },
    # caffe.proto:666-668
    "HDF5OutputParameter": {1: ("file_name", "string")},
    # caffe.proto:670-677
    "HingeLossParameter": {1: ("norm", "enum:HingeNorm")},
    # caffe.proto:679-708
    "ImageDataParameter": {
        1: ("source", "string"), 4: ("batch_size", "uint32"),
        7: ("rand_skip", "uint32"), 8: ("shuffle", "bool"),
        9: ("new_height", "uint32"), 10: ("new_width", "uint32"),
        11: ("is_color", "bool"), 2: ("scale", "float"),
        3: ("mean_file", "string"), 5: ("crop_size", "uint32"),
        6: ("mirror", "bool"), 12: ("root_folder", "string"),
    },
    # caffe.proto:710-713
    "InfogainLossParameter": {1: ("source", "string")},
    # caffe.proto:715-726
    "InnerProductParameter": {
        1: ("num_output", "uint32"), 2: ("bias_term", "bool"),
        3: ("weight_filler", "msg:FillerParameter"),
        4: ("bias_filler", "msg:FillerParameter"), 5: ("axis", "int32"),
    },
    # caffe.proto:728-736
    "LogParameter": {
        1: ("base", "float"), 2: ("scale", "float"), 3: ("shift", "float"),
    },
    # caffe.proto:738-754
    "LRNParameter": {
        1: ("local_size", "uint32"), 2: ("alpha", "float"),
        3: ("beta", "float"), 4: ("norm_region", "enum:NormRegion"),
        5: ("k", "float"), 6: ("engine", "enum:Engine"),
    },
    # caffe.proto:756-761
    "MemoryDataParameter": {
        1: ("batch_size", "uint32"), 2: ("channels", "uint32"),
        3: ("height", "uint32"), 4: ("width", "uint32"),
    },
    # caffe.proto:763-772
    "MVNParameter": {
        1: ("normalize_variance", "bool"), 2: ("across_channels", "bool"),
        3: ("eps", "float"),
    },
    # caffe.proto:774-801
    "PoolingParameter": {
        1: ("pool", "enum:PoolMethod"), 4: ("pad", "uint32"),
        9: ("pad_h", "uint32"), 10: ("pad_w", "uint32"),
        2: ("kernel_size", "uint32"), 5: ("kernel_h", "uint32"),
        6: ("kernel_w", "uint32"), 3: ("stride", "uint32"),
        7: ("stride_h", "uint32"), 8: ("stride_w", "uint32"),
        11: ("engine", "enum:Engine"), 12: ("global_pooling", "bool"),
    },
    # caffe.proto:803-808
    "PowerParameter": {
        1: ("power", "float"), 2: ("scale", "float"), 3: ("shift", "float"),
    },
    # caffe.proto:810-822
    "PythonParameter": {
        1: ("module", "string"), 2: ("layer", "string"),
        3: ("param_str", "string"), 4: ("share_in_parallel", "bool"),
    },
    # caffe.proto:825-851
    "ReductionParameter": {
        1: ("operation", "enum:ReductionOp"), 2: ("axis", "int32"),
        3: ("coeff", "float"),
    },
    # caffe.proto:854-867
    "ReLUParameter": {
        1: ("negative_slope", "float"), 2: ("engine", "enum:Engine"),
    },
    # caffe.proto:869-931
    "ReshapeParameter": {
        1: ("shape", "msg:BlobShape"), 2: ("axis", "int32"),
        3: ("num_axes", "int32"),
    },
    # caffe.proto:933-940
    "SigmoidParameter": {1: ("engine", "enum:Engine")},
    # caffe.proto:942-951
    "SliceParameter": {
        3: ("axis", "int32"), 2: ("slice_point", "uint32"),
        1: ("slice_dim", "uint32"),
    },
    # caffe.proto:954-966
    "SoftmaxParameter": {1: ("engine", "enum:Engine"), 2: ("axis", "int32")},
    # caffe.proto:968-975
    "TanHParameter": {1: ("engine", "enum:Engine")},
    # caffe.proto:978-984
    "TileParameter": {1: ("axis", "int32"), 2: ("tiles", "int32")},
    # caffe.proto:987-989
    "ThresholdParameter": {1: ("threshold", "float")},
    # caffe.proto:991-993 (fork delta; label_shape=2 is this repo's
    # compatible extension, emitted only when present)
    "JavaDataParameter": {
        1: ("shape", "msg:BlobShape"), 2: ("label_shape", "msg:BlobShape"),
    },
    # caffe.proto:995-1026
    "WindowDataParameter": {
        1: ("source", "string"), 2: ("scale", "float"),
        3: ("mean_file", "string"), 4: ("batch_size", "uint32"),
        5: ("crop_size", "uint32"), 6: ("mirror", "bool"),
        7: ("fg_threshold", "float"), 8: ("bg_threshold", "float"),
        9: ("fg_fraction", "float"), 10: ("context_pad", "uint32"),
        11: ("crop_mode", "string"), 12: ("cache_images", "bool"),
        13: ("root_folder", "string"),
    },
    # caffe.proto:1028-1042
    "SPPParameter": {
        1: ("pyramid_height", "uint32"), 2: ("pool", "enum:PoolMethod"),
        6: ("engine", "enum:Engine"),
    },
    # caffe.proto:1231-1239
    "PReLUParameter": {
        1: ("filler", "msg:FillerParameter"), 2: ("channel_shared", "bool"),
    },
    # caffe.proto:1045-1134
    "V1LayerParameter": {
        2: ("bottom", "string"), 3: ("top", "string"), 4: ("name", "string"),
        32: ("include", "msg:NetStateRule"),
        33: ("exclude", "msg:NetStateRule"),
        5: ("type", "enum:V1LayerType"), 6: ("blobs", "msg:BlobProto"),
        1001: ("param", "string"),
        1002: ("blob_share_mode", "enum:DimCheckMode"),
        7: ("blobs_lr", "float"), 8: ("weight_decay", "float"),
        35: ("loss_weight", "float"),
        27: ("accuracy_param", "msg:AccuracyParameter"),
        23: ("argmax_param", "msg:ArgMaxParameter"),
        9: ("concat_param", "msg:ConcatParameter"),
        40: ("contrastive_loss_param", "msg:ContrastiveLossParameter"),
        10: ("convolution_param", "msg:ConvolutionParameter"),
        11: ("data_param", "msg:DataParameter"),
        12: ("dropout_param", "msg:DropoutParameter"),
        26: ("dummy_data_param", "msg:DummyDataParameter"),
        24: ("eltwise_param", "msg:EltwiseParameter"),
        41: ("exp_param", "msg:ExpParameter"),
        13: ("hdf5_data_param", "msg:HDF5DataParameter"),
        14: ("hdf5_output_param", "msg:HDF5OutputParameter"),
        29: ("hinge_loss_param", "msg:HingeLossParameter"),
        15: ("image_data_param", "msg:ImageDataParameter"),
        16: ("infogain_loss_param", "msg:InfogainLossParameter"),
        17: ("inner_product_param", "msg:InnerProductParameter"),
        18: ("lrn_param", "msg:LRNParameter"),
        22: ("memory_data_param", "msg:MemoryDataParameter"),
        34: ("mvn_param", "msg:MVNParameter"),
        19: ("pooling_param", "msg:PoolingParameter"),
        21: ("power_param", "msg:PowerParameter"),
        30: ("relu_param", "msg:ReLUParameter"),
        38: ("sigmoid_param", "msg:SigmoidParameter"),
        39: ("softmax_param", "msg:SoftmaxParameter"),
        31: ("slice_param", "msg:SliceParameter"),
        37: ("tanh_param", "msg:TanHParameter"),
        25: ("threshold_param", "msg:ThresholdParameter"),
        20: ("window_data_param", "msg:WindowDataParameter"),
        36: ("transform_param", "msg:TransformationParameter"),
        42: ("loss_param", "msg:LossParameter"),
        1: ("layer", "msg:V0LayerParameter"),
    },
    # caffe.proto:1139-1229
    "V0LayerParameter": {
        1: ("name", "string"), 2: ("type", "string"),
        3: ("num_output", "uint32"), 4: ("biasterm", "bool"),
        5: ("weight_filler", "msg:FillerParameter"),
        6: ("bias_filler", "msg:FillerParameter"), 7: ("pad", "uint32"),
        8: ("kernelsize", "uint32"), 9: ("group", "uint32"),
        10: ("stride", "uint32"), 11: ("pool", "enum:PoolMethod"),
        12: ("dropout_ratio", "float"), 13: ("local_size", "uint32"),
        14: ("alpha", "float"), 15: ("beta", "float"), 22: ("k", "float"),
        16: ("source", "string"), 17: ("scale", "float"),
        18: ("meanfile", "string"), 19: ("batchsize", "uint32"),
        20: ("cropsize", "uint32"), 21: ("mirror", "bool"),
        50: ("blobs", "msg:BlobProto"), 51: ("blobs_lr", "float"),
        52: ("weight_decay", "float"), 53: ("rand_skip", "uint32"),
        54: ("det_fg_threshold", "float"), 55: ("det_bg_threshold", "float"),
        56: ("det_fg_fraction", "float"), 58: ("det_context_pad", "uint32"),
        59: ("det_crop_mode", "string"), 60: ("new_num", "int32"),
        61: ("new_channels", "int32"), 62: ("new_height", "int32"),
        63: ("new_width", "int32"), 64: ("shuffle_images", "bool"),
        65: ("concat_dim", "uint32"),
        1001: ("hdf5_output_param", "msg:HDF5OutputParameter"),
    },
}

_NAME_REV: dict[str, dict[str, tuple[int, str]]] = {
    msg: {name: (num, kind) for num, (name, kind) in fields.items()}
    for msg, fields in MESSAGES.items()
}

_SCALAR_WIRE = {
    "int32": _VARINT, "int64": _VARINT, "uint32": _VARINT,
    "uint64": _VARINT, "bool": _VARINT, "float": _I32, "double": _I64,
}


class WireError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Varint primitives
# ---------------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise WireError("varint too long")


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value += 1 << 64  # two's-complement, as proto2 encodes negatives
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _skip_field(buf: memoryview, pos: int, wire: int) -> int:
    if wire == _VARINT:
        _, pos = _read_varint(buf, pos)
    elif wire == _I64:
        pos += 8
    elif wire == _LEN:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == _I32:
        pos += 4
    else:
        raise WireError(f"cannot skip wire type {wire}")
    if pos > len(buf):
        raise WireError("truncated field")
    return pos


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode(data: bytes | memoryview, msg_type: str) -> PMessage:
    """Decode binary protobuf bytes into a PMessage using the schema."""
    fields = MESSAGES.get(msg_type)
    if fields is None:
        raise WireError(f"unknown message type {msg_type!r}")
    buf = memoryview(data) if not isinstance(data, memoryview) else data
    msg = PMessage()
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field_num, wire = key >> 3, key & 7
        entry = fields.get(field_num)
        if entry is None:
            pos = _skip_field(buf, pos, wire)
            continue
        name, kind = entry
        if kind.startswith("msg:"):
            if wire != _LEN:
                raise WireError(f"{msg_type}.{name}: expected LEN wire")
            ln, pos = _read_varint(buf, pos)
            msg.add(name, decode(buf[pos:pos + ln], kind[4:]))
            pos += ln
        elif kind.startswith("enum:"):
            table = ENUMS[kind[5:]]

            def _enum(v):
                # EnumToken keeps binary->text round-trips writing bare
                # enum identifiers (textformat serialization contract)
                got = table.get(v)
                return EnumToken(got) if got is not None else int(v)
            if wire == _LEN:  # packed repeated enum
                ln, pos = _read_varint(buf, pos)
                end = pos + ln
                while pos < end:
                    v, pos = _read_varint(buf, pos)
                    msg.add(name, _enum(v))
            else:
                v, pos = _read_varint(buf, pos)
                msg.add(name, _enum(v))
        elif kind in ("pfloat32", "pfloat64", "pint64"):
            pos = _decode_packed(buf, pos, wire, kind, msg, name, msg_type)
        elif kind == "float":
            if wire == _LEN:  # packed encoding of a repeated float
                ln, pos = _read_varint(buf, pos)
                for v in np.frombuffer(buf[pos:pos + ln], "<f4"):
                    msg.add(name, float(v))
                pos += ln
            else:
                msg.add(name, struct.unpack_from("<f", buf, pos)[0])
                pos += 4
        elif kind == "double":
            msg.add(name, struct.unpack_from("<d", buf, pos)[0])
            pos += 8
        elif kind == "bool":
            if wire == _LEN:  # packed repeated bool
                ln, pos = _read_varint(buf, pos)
                end = pos + ln
                while pos < end:
                    v, pos = _read_varint(buf, pos)
                    msg.add(name, bool(v))
            else:
                v, pos = _read_varint(buf, pos)
                msg.add(name, bool(v))
        elif kind in ("int32", "int64"):
            if wire == _LEN:  # packed
                ln, pos = _read_varint(buf, pos)
                end = pos + ln
                while pos < end:
                    v, pos = _read_varint(buf, pos)
                    msg.add(name, _signed(v))
            else:
                v, pos = _read_varint(buf, pos)
                msg.add(name, _signed(v))
        elif kind in ("uint32", "uint64"):
            if wire == _LEN:
                ln, pos = _read_varint(buf, pos)
                end = pos + ln
                while pos < end:
                    v, pos = _read_varint(buf, pos)
                    msg.add(name, v)
            else:
                v, pos = _read_varint(buf, pos)
                msg.add(name, v)
        elif kind == "string":
            ln, pos = _read_varint(buf, pos)
            msg.add(name, bytes(buf[pos:pos + ln]).decode("utf-8", "replace"))
            pos += ln
        elif kind == "bytes":
            ln, pos = _read_varint(buf, pos)
            msg.add(name, bytes(buf[pos:pos + ln]))
            pos += ln
        else:
            raise WireError(f"unknown kind {kind!r}")
        if pos > n:
            raise WireError(f"{msg_type}.{name}: truncated")
    return msg


def _decode_packed(buf, pos, wire, kind, msg, name, msg_type):
    """Numpy fast path for large packed vectors (BlobProto.data etc.)."""
    dt = {"pfloat32": "<f4", "pfloat64": "<f8"}.get(kind)
    if wire == _LEN:
        ln, pos = _read_varint(buf, pos)
        if dt is not None:
            # a read-only view of the input bytes: no copy of the floats
            msg.add(name, np.frombuffer(buf[pos:pos + ln], dt))
        else:  # pint64: varint-packed
            end = pos + ln
            vals = []
            p = pos
            while p < end:
                v, p = _read_varint(buf, p)
                vals.append(_signed(v))
            msg.add(name, np.asarray(vals, np.int64))
        return pos + ln
    # unpacked scalar record: append as a 1-element array
    if kind == "pfloat32":
        msg.add(name, np.asarray(
            [struct.unpack_from("<f", buf, pos)[0]], np.float32))
        return pos + 4
    if kind == "pfloat64":
        msg.add(name, np.asarray(
            [struct.unpack_from("<d", buf, pos)[0]], np.float64))
        return pos + 8
    v, pos = _read_varint(buf, pos)
    msg.add(name, np.asarray([_signed(v)], np.int64))
    return pos


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def encode(msg: PMessage, msg_type: str) -> bytes:
    """Encode a PMessage to binary protobuf bytes using the schema."""
    rev = _NAME_REV.get(msg_type)
    if rev is None:
        raise WireError(f"unknown message type {msg_type!r}")
    out = bytearray()
    for name, val in msg.items():
        entry = rev.get(name)
        if entry is None:
            raise WireError(f"{msg_type} has no field named {name!r}")
        num, kind = entry
        _encode_field(out, num, kind, val, msg_type, name)
    return bytes(out)


def _tag(out: bytearray, num: int, wire: int) -> None:
    _write_varint(out, (num << 3) | wire)


def _encode_field(out, num, kind, val, msg_type, name):
    if kind.startswith("msg:"):
        if not isinstance(val, PMessage):
            raise WireError(f"{msg_type}.{name}: expected PMessage")
        body = encode(val, kind[4:])
        _tag(out, num, _LEN)
        _write_varint(out, len(body))
        out += body
    elif kind.startswith("enum:"):
        if isinstance(val, str):
            table = _ENUM_REV[kind[5:]]
            if val not in table:
                raise WireError(f"{msg_type}.{name}: unknown enum {val!r}")
            val = table[val]
        _tag(out, num, _VARINT)
        _write_varint(out, int(val))
    elif kind in ("pfloat32", "pfloat64", "pint64"):
        arr = np.asarray(val)
        if kind == "pint64":
            body = bytearray()
            for v in arr.astype(np.int64).ravel():
                _write_varint(body, int(v))
            body = bytes(body)
        else:
            dt = "<f4" if kind == "pfloat32" else "<f8"
            body = arr.astype(dt).ravel().tobytes()
        _tag(out, num, _LEN)
        _write_varint(out, len(body))
        out += body
    elif kind == "float":
        _tag(out, num, _I32)
        out += struct.pack("<f", float(val))
    elif kind == "double":
        _tag(out, num, _I64)
        out += struct.pack("<d", float(val))
    elif kind == "bool":
        _tag(out, num, _VARINT)
        _write_varint(out, 1 if val else 0)
    elif kind in ("int32", "int64", "uint32", "uint64"):
        _tag(out, num, _VARINT)
        _write_varint(out, int(val))
    elif kind == "string":
        body = str(val).encode("utf-8")
        _tag(out, num, _LEN)
        _write_varint(out, len(body))
        out += body
    elif kind == "bytes":
        body = bytes(val)
        _tag(out, num, _LEN)
        _write_varint(out, len(body))
        out += body
    else:
        raise WireError(f"unknown kind {kind!r}")
