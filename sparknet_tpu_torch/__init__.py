"""SparkNet on PyTorch and CUDA: the port of ``sparknet_tpu`` to one NVIDIA
H100.

It imports ``torch``, never ``jax``, and nothing of ``sparknet_tpu``; it
keeps its own copies of what it needs from that package.  Subpackages and
modules mirror the JAX package's names.  It serves (zoo model ->
``parallel.serving.ModelHouse`` -> ``InferenceEngine`` micro-batched
forward) and trains (``apps.imagenet_app``, ``apps.cifar_app`` ->
``apps.common.run_training`` -> the prefetching ``data.prefetch``
feed -> ``parallel.trainer.DistributedTrainer``; or Caffe's
``solvers.Solver``), reads and writes Caffe's ``.caffemodel`` and
``.solverstate`` files (``proto.caffemodel``), with the JAX package's
Pallas kernels as hand-written CUDA kernels (``ops/csrc/``).
"""
