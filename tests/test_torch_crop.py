"""The port's crop on the device (``parallel/trainer.py``:
``crop_mirror_mean``, ``device_crop_mirror_mean`` and
``TrainerConfig.device_preprocess``) on the CPU.

- Against numpy, bit for bit: with the same offsets and flips,
  ``crop_mirror_mean`` equals the port's and the JAX package's host
  ``random_crop_mirror``, with a full-size mean, with no mean, mirror on
  and off, and at crop == size.  A crop-sized mean is where the JAX
  package's two paths part: its host crop subtracts it after the mirror,
  its device crop before (at unmirrored coordinates, data_transformer.cpp).
  The port's device crop follows the JAX device crop, so against numpy
  it matches on unmirrored samples and, on mirrored ones, numpy run with
  the mean mirrored.
- Against JAX, bit for bit: each sample's (y, x, flip) is recovered from
  ``sparknet_tpu.parallel.device_crop_mirror_mean``'s output on a
  random-normal batch, for several keys; the port's crop at those offsets
  equals JAX's output for both mean shapes.  A mean of neither shape
  raises in both.  The port's offsets cover [0, size - crop] and its
  flip rate is within 0.05 of 0.5 over 4,000 draws (6 standard errors).
- Through the trainer: crop == size and mirror off gives the host path's
  round exactly, in the port, ``local_sgd`` and ``sync``, and tracks the
  JAX trainer's device-preprocess round at rtol 2e-4, atol 2e-5 (the
  bound of tests/test_torch_trainer.py); a real random crop gives the
  round of the same crops made on the host from the trainer's per-worker
  generators, exactly.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sparknet_tpu.data import transforms as jax_transforms
from sparknet_tpu.models import lenet as jax_lenet
from sparknet_tpu.parallel import DistributedTrainer as JaxTrainer
from sparknet_tpu.parallel import TrainerConfig as JaxConfig
from sparknet_tpu.parallel import device_crop_mirror_mean as jax_device_crop
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_solver
from sparknet_tpu_torch.convert import params_from_jax
from sparknet_tpu_torch.data import random_crop_mirror
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                 TrainerConfig,
                                                 crop_mirror_mean,
                                                 device_crop_mirror_mean)
from sparknet_tpu_torch.proto import load_solver_prototxt_with_net

RTOL, ATOL = 2e-4, 2e-5
SOLVER_TXT = 'base_lr: 0.05\nmomentum: 0.9\nlr_policy: "fixed"\n'


def _draws(seed, n, h, w, crop, mirror):
    """The host crop's draws, in its order (ys, xs, flips)."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, h - crop + 1, size=n)
    xs = rng.integers(0, w - crop + 1, size=n)
    flips = rng.integers(0, 2, size=n) if mirror else np.zeros(n, np.int64)
    return ys, xs, flips


def _port(batch, ys, xs, flips, crop, mean):
    return crop_mirror_mean(
        torch.from_numpy(batch), torch.from_numpy(np.asarray(ys)),
        torch.from_numpy(np.asarray(xs)), torch.from_numpy(np.asarray(flips)),
        crop, None if mean is None else torch.from_numpy(mean)).numpy()


@pytest.mark.parametrize("mirror", [True, False])
@pytest.mark.parametrize("size,crop,mean", [
    (11, 7, "full"), (11, 7, None), (9, 9, None), (9, 9, "crop"),
    (11, 7, "crop")])
def test_crop_equals_numpy_bit_for_bit(size, crop, mean, mirror):
    rng = np.random.default_rng(size * 10 + crop)
    batch = rng.uniform(0, 255, (6, 3, size, size)).astype(np.float32)
    m = None
    if mean == "full":
        m = rng.uniform(0, 255, (3, size, size)).astype(np.float32)
    elif mean == "crop":
        m = rng.uniform(0, 255, (3, crop, crop)).astype(np.float32)
    ys, xs, flips = _draws(5, 6, size, size, crop, mirror)
    got = _port(batch, ys, xs, flips, crop, m)
    assert got.dtype == np.float32 and got.shape == (6, 3, crop, crop)
    host = random_crop_mirror(batch, crop, np.random.default_rng(5),
                              mirror=mirror, mean=m)
    jhost = jax_transforms.random_crop_mirror(
        batch, crop, np.random.default_rng(5), mirror=mirror, mean=m)
    assert host.tobytes() == jhost.tobytes()
    crop_sized = m is not None and m.shape[-2:] == (crop, crop)
    plain = flips == 0 if crop_sized else np.ones(6, bool)
    assert got[plain].tobytes() == host[plain].tobytes()
    if crop_sized and mirror:
        mirrored = random_crop_mirror(batch, crop, np.random.default_rng(5),
                                      mirror=True, mean=m[:, :, ::-1].copy())
        assert flips.any() and got[~plain].tobytes() == \
            mirrored[~plain].tobytes()


def _recover(batch, out, crop):
    """Each sample's (y, x, flip) from a crop of ``batch`` (random-normal:
    every window is unique)."""
    n, _, h, w = batch.shape
    found = []
    for i in range(n):
        hits = [(y, x, f) for y in range(h - crop + 1)
                for x in range(w - crop + 1) for f in (0, 1)
                if np.array_equal(
                    batch[i, :, y:y + crop, x:x + crop][..., ::-1]
                    if f else batch[i, :, y:y + crop, x:x + crop], out[i])]
        assert len(hits) == 1, (i, hits)
        found.append(hits[0])
    return np.asarray(found).T


@pytest.mark.parametrize("key", [0, 1, 7])
def test_crop_equals_jax_device_crop_at_recovered_offsets(key):
    rng = np.random.default_rng(100 + key)
    size, crop, n = 10, 7, 8
    x = rng.normal(size=(2, n // 2, 3, size, size)).astype(np.float32)
    full = rng.normal(size=(3, size, size)).astype(np.float32)
    crop_m = rng.normal(size=(3, crop, crop)).astype(np.float32)
    k = jax.random.PRNGKey(key)
    plain = np.asarray(jax_device_crop(crop)({"data": x}, k)["data"])
    ys, xs, flips = _recover(x.reshape(n, 3, size, size),
                             plain.reshape(n, 3, crop, crop), crop)
    for m in (None, full, crop_m):
        want = np.asarray(jax_device_crop(crop, mean=m)(
            {"data": x}, k)["data"]).reshape(n, 3, crop, crop)
        got = _port(x.reshape(n, 3, size, size), ys, xs, flips, crop, m)
        assert got.tobytes() == want.tobytes()


def test_a_mean_of_neither_shape_raises_in_both():
    x = np.zeros((2, 1, 6, 6), np.float32)
    bad = np.zeros((1, 5, 5), np.float32)
    with pytest.raises(ValueError, match="matches neither"):
        device_crop_mirror_mean(4, mean=bad)({"data": torch.from_numpy(x)},
                                             torch.Generator())
    with pytest.raises(ValueError, match="matches neither"):
        jax_device_crop(4, mean=bad)({"data": x}, jax.random.PRNGKey(0))


def test_offsets_cover_the_range_and_flip_half_the_time():
    pre = device_crop_mirror_mean(5)
    gen = torch.Generator().manual_seed(3)
    offs = torch.cat([pre.draw(100, 9, 12, gen) for _ in range(40)], 1)
    ys, xs, flips = offs.numpy()
    assert set(ys) == set(range(5)) and set(xs) == set(range(8))
    assert abs(flips.mean() - 0.5) < 0.05
    still = device_crop_mirror_mean(5, mirror=False).draw(50, 9, 12, gen)
    assert not still[2].any()


def _lenet_trainers(strategy, pre, *, tau=2, n_workers=2, seed=0):
    sp = load_solver_prototxt_with_net(SOLVER_TXT, lenet(8, 8))
    return (DistributedTrainer(sp, n_workers, TrainerConfig(
        strategy=strategy, tau=tau, device_preprocess=pre), seed=seed,
        device="cpu"),
        DistributedTrainer(sp, n_workers, TrainerConfig(
            strategy=strategy, tau=tau), seed=seed, device="cpu"))


def _assert_params_equal(a, b):
    for k, blobs in a.params.items():
        for i, p in enumerate(blobs):
            assert torch.equal(p, b.params[k][i]), f"{k}[{i}]"


@pytest.mark.parametrize("strategy", ["local_sgd", "sync"])
def test_crop_of_the_whole_image_is_the_host_round(strategy):
    """tests/test_parallel.py:325-356 in the port: with crop == size and
    mirror off the device path is the host path's mean subtraction, and
    the rounds are equal bit for bit; against the JAX trainer's device
    path the round tracks at the trainer tests' bound."""
    rng = np.random.default_rng(11)
    mean = rng.normal(size=(1, 28, 28)).astype(np.float32)
    x = rng.normal(scale=0.5, size=(2, 8, 1, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, size=(2, 8)).astype(np.float32)
    dev, host = _lenet_trainers(
        strategy, device_crop_mirror_mean(28, mirror=False, mean=mean))
    jtr = JaxTrainer(jax_solver(SOLVER_TXT, jax_lenet(8, 8)), make_mesh(2),
                     JaxConfig(strategy=strategy, tau=2,
                               device_preprocess=jax_device_crop(
                                   28, mirror=False, mean=mean)), seed=0)
    start = params_from_jax(jax.device_get(jtr.params), dev.train_net,
                            device="cpu")
    dev.params = start
    host.params = {k: [b.clone() for b in v] for k, v in start.items()}
    for r in range(2):
        batches = {"data": x + r, "label": y}
        loss = dev.train_round(batches)
        assert loss == host.train_round({"data": batches["data"] - mean,
                                         "label": y})
        _assert_params_equal(dev, host)
        jloss = jtr.train_round(batches)
        np.testing.assert_allclose(loss, jloss, rtol=RTOL)
        want = jax.device_get(jtr.params)
        for k, blobs in dev.params.items():
            for i, b in enumerate(blobs):
                np.testing.assert_allclose(
                    b.numpy(), np.asarray(want[k][i]), rtol=RTOL, atol=ATOL,
                    err_msg=f"round {r} {k}[{i}]")


@pytest.mark.parametrize("strategy,iter_size", [
    ("local_sgd", 1), ("local_sgd", 2), ("sync", 2)])
def test_random_crop_draws_from_each_workers_generator(strategy, iter_size):
    """A 28 crop of 32x32 images, mirror on, a full-size mean: the round
    equals the host round of the same crops, made from copies of the
    trainer's per-worker generators, each drawing its worker's steps in
    order over each step's iter_size x batch images."""
    rng = np.random.default_rng(12)
    tau, n_workers, b = 2, 2, 4
    mean = rng.uniform(0, 1, size=(1, 32, 32)).astype(np.float32)
    x = rng.normal(size=(tau * iter_size, n_workers * b, 1, 32, 32)).astype(
        np.float32)
    y = rng.integers(0, 10, size=(tau * iter_size, n_workers * b)).astype(
        np.float32)
    pre = device_crop_mirror_mean(28, mirror=True, mean=mean)
    txt = SOLVER_TXT + f"iter_size: {iter_size}\n"
    sp = load_solver_prototxt_with_net(txt, lenet(b * n_workers,
                                                  b * n_workers))
    dev = DistributedTrainer(sp, n_workers, TrainerConfig(
        strategy=strategy, tau=tau, device_preprocess=pre), seed=3,
        device="cpu")
    host = DistributedTrainer(sp, n_workers, TrainerConfig(
        strategy=strategy, tau=tau), seed=3, device="cpu")
    gens = [torch.Generator().set_state(g.get_state())
            for g in dev.crop_generators]
    cropped = np.empty(x.shape[:2] + (1, 28, 28), np.float32)
    for w in range(n_workers):
        for t in range(tau):
            rows = slice(t * iter_size, (t + 1) * iter_size)
            cols = slice(w * b, (w + 1) * b)
            micro = x[rows, cols].reshape(iter_size * b, 1, 32, 32)
            ys, xs, flips = pre.draw(iter_size * b, 32, 32, gens[w])
            cropped[rows, cols] = _port(micro, ys.numpy(), xs.numpy(),
                                        flips.numpy(), 28, mean).reshape(
                iter_size, b, 1, 28, 28)
    assert dev.train_round({"data": x, "label": y}) == host.train_round(
        {"data": cropped, "label": y})
    _assert_params_equal(dev, host)
