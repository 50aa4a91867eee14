"""SparkNet on PyTorch and CUDA: the port of ``sparknet_tpu`` to one NVIDIA
H100.

It imports ``torch``, never ``jax``, and nothing of ``sparknet_tpu``; it
keeps its own copies of what it needs from that package.  Subpackages and
modules mirror the JAX package's names.  So far it serves: zoo model ->
``parallel.serving.ModelHouse`` -> ``InferenceEngine`` micro-batched
forward, with ACROSS_CHANNELS LRN as a hand-written CUDA kernel
(``ops/csrc/lrn.cu``).
"""
