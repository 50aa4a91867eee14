"""Minibatch assembly and sampling.

The port's own copy of ``sparknet_tpu/data/minibatch.py``; batches stay
numpy arrays on the host, as the Solver's feed takes them.

``make_minibatches`` mirrors ScaleAndConvert.makeMinibatchRDD's grouping
with drop-remainder semantics (reference:
src/main/scala/preprocessing/ScaleAndConvert.scala:30-55).

``MinibatchSampler`` mirrors the reference's per-partition sampler
(reference: src/main/scala/libs/MinibatchSampler.scala): given a partition
of ``total`` minibatches, sample a random *contiguous run* of ``num`` of
them (:18-19) and serve aligned image/label minibatches.  Here images and
labels travel together — the reference splits them into two streams only
because Caffe pulls data and labels through two separate C callbacks
(reference: Net.scala:154-193)."""

from __future__ import annotations

from typing import Any, Callable, Iterator, Sequence

import numpy as np


def make_minibatches(images: np.ndarray, labels: np.ndarray, batch_size: int,
                     ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Group into fixed-size (image, label) minibatches, dropping the
    remainder."""
    n = (len(labels) // batch_size) * batch_size
    return [
        (images[i:i + batch_size], labels[i:i + batch_size])
        for i in range(0, n, batch_size)
    ]


class MinibatchSampler:
    """Sample a contiguous run of ``num`` minibatches out of ``total``."""

    def __init__(self, minibatches: Sequence[tuple[np.ndarray, np.ndarray]],
                 num: int, seed: int | None = None):
        total = len(minibatches)
        if num > total:
            raise ValueError(f"asked for {num} of {total} minibatches")
        rng = np.random.default_rng(seed)
        start = int(rng.integers(0, total - num + 1))
        self._batches = list(minibatches[start:start + num])
        self._i = 0

    def __iter__(self) -> "MinibatchSampler":
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        if self._i >= len(self._batches):
            raise StopIteration
        b = self._batches[self._i]
        self._i += 1
        return b


def batch_feed(minibatches: Iterator[tuple[np.ndarray, np.ndarray]],
               preprocess: Callable[[np.ndarray], np.ndarray] | None = None,
               data_key: str = "data", label_key: str = "label",
               ) -> Iterator[dict[str, Any]]:
    """Adapt (image, label) minibatches to the Solver's input-dict feed,
    applying a preprocessing closure per batch (the setTrainData(sampler,
    preprocess) shape; reference: Net.scala:79-84)."""
    for images, labels in minibatches:
        if preprocess is not None:
            images = preprocess(images)
        # asarray, not astype: when the sampler already holds f32 (every
        # preprocessed path does) this is a no-op instead of a whole-batch
        # copy per step — the feed hot loop must not pay a memcpy for a
        # dtype it already has
        yield {data_key: np.asarray(images, np.float32),
               label_key: np.asarray(labels, np.float32)}
