"""The port's ``mnist``, ``minibatch`` and ``synthgen`` against the JAX
package's, on the CPU, bit for bit: idx files written by either package
read back equal in both; ``make_minibatches``, ``MinibatchSampler`` and
``batch_feed`` give the same arrays; ``synth_textures`` and
``synth_splits`` give the same images and labels from the same seeds."""

from __future__ import annotations

import numpy as np
import pytest

from sparknet_tpu.data import minibatch as jmb
from sparknet_tpu.data import mnist as jmnist
from sparknet_tpu.data import synthgen as jsg
from sparknet_tpu_torch.data import minibatch, mnist, synthgen


def _digits(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(n, 1, 28, 28)).astype(np.uint8),
            rng.integers(0, 10, size=n))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mnist_idx_round_trips_both_ways(tmp_path, writer):
    imgs, labels = _digits(9)
    img_p, lab_p = str(tmp_path / "i.idx3"), str(tmp_path / "l.idx1")
    (mnist if writer == "port" else jmnist).write_mnist_idx(
        img_p, lab_p, imgs, labels)
    ours, theirs = mnist.load_mnist_idx(img_p, lab_p), \
        jmnist.load_mnist_idx(img_p, lab_p)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert ours[0].dtype == np.float32 and ours[0].shape == (9, 1, 28, 28)
    np.testing.assert_array_equal(ours[0], imgs)
    np.testing.assert_array_equal(ours[1], labels)


def test_mnist_idx_bad_magic_raises(tmp_path):
    imgs, labels = _digits(10)          # an idx1 file of 18 bytes
    img_p, lab_p = str(tmp_path / "i"), str(tmp_path / "l")
    mnist.write_mnist_idx(img_p, lab_p, imgs, labels)
    with pytest.raises(ValueError, match="idx3 magic"):
        mnist.load_mnist_idx(lab_p, lab_p)


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            x, y = list(x.values()), list(y.values())
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


@pytest.mark.parametrize("batch", [3, 4, 11])
def test_make_minibatches_and_sampler_equal_jax(batch):
    imgs, labels = _digits(22, seed=1)
    ours = minibatch.make_minibatches(imgs, labels, batch)
    theirs = jmb.make_minibatches(imgs, labels, batch)
    _same_batches(ours, theirs)
    num = min(2, len(ours))
    _same_batches(list(minibatch.MinibatchSampler(ours, num, seed=5)),
                  list(jmb.MinibatchSampler(theirs, num, seed=5)))
    with pytest.raises(ValueError, match="asked for"):
        minibatch.MinibatchSampler(ours, len(ours) + 1)


def test_batch_feed_equals_jax():
    imgs, labels = _digits(12, seed=2)
    pre = lambda x: x.astype(np.float32) / 255.0  # noqa: E731
    for p in (None, pre):
        ours = list(minibatch.batch_feed(
            iter(minibatch.make_minibatches(imgs, labels, 4)), p))
        theirs = list(jmb.batch_feed(
            iter(jmb.make_minibatches(imgs, labels, 4)), p))
        _same_batches(ours, theirs)
        assert ours[0]["data"].dtype == np.float32


@pytest.mark.parametrize("kw", [{}, {"image_size": 16, "template_size": 5,
                                     "n_classes": 4, "noise": 0.5}])
def test_synth_textures_equal_jax(kw):
    x, y = synthgen.synth_textures(13, seed=4, **kw)
    jx, jy = jsg.synth_textures(13, seed=4, **kw)
    assert x.dtype == jx.dtype and x.tobytes() == jx.tobytes()
    assert y.dtype == jy.dtype and y.tobytes() == jy.tobytes()


def test_synth_splits_equal_jax():
    ours = synthgen.synth_splits(6, 5, image_size=12, template_size=4)
    theirs = jsg.synth_splits(6, 5, image_size=12, template_size=4)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
