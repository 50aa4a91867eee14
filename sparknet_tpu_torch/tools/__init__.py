"""Caffe's command-line tools on the port: ``caffe_cli`` (train, test,
time, device_query), ``time_net``, ``compute_image_mean``,
``extract_features`` and ``convert_imageset``."""
