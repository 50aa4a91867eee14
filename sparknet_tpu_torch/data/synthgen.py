"""Generalization-bearing synthetic image classification data.

The port's own copy of ``sparknet_tpu/data/synthgen.py``: the same draws
from the same seeds, bit for bit.

Why: a simpler synthetic proxy (`apps/cifar_app.synthetic_cifar`, one
bright stripe per class) is
linearly separable, so cifar10_full drives it to accuracy 1.0 by iter
1000 and neither generalization nor the published multistep schedule is
actually evidenced.  This generator produces data with the properties
real CIFAR training exhibits, so the full published schedule
(Caffe's `examples/cifar10/cifar10_full_solver.prototxt` + its _lr1/_lr2
continuations) has something real to do:

- **Class structure a convnet must learn**: each class owns a bank of
  frozen random texture templates; a sample pastes several of its
  class's templates at random positions/flips.  Position randomness
  means a linear readout over pixels cannot solve it — detecting the
  textures translation-invariantly (convolution + pooling) is the
  intended solution.
- **Irreducible error**: every sample also carries *distractor*
  templates drawn from OTHER classes at lower amplitude, plus strong
  pixel noise.  Class evidence is a signal-to-noise ratio, not a
  certainty: Bayes error > 0, so held-out accuracy saturates below 1.0
  and train/test gap stays positive.
- **Responds to lr drops**: with SGD+momentum at the published lr, the
  accuracy curve plateaus in noise and the multistep x0.1 drops produce
  the visible late-schedule step-up real CIFAR shows.

All "world" parameters (the template banks) come from a seed so train
and test splits share the same classes; sample draws use independent
seeds per split.
"""

from __future__ import annotations

import numpy as np

N_CLASSES = 10


def _template_bank(rng: np.random.Generator, n_classes: int,
                   per_class: int, size: int) -> np.ndarray:
    """(n_classes, per_class, 3, size, size) frozen texture templates —
    smoothed gaussian noise so each is a soft local texture, unit RMS."""
    raw = rng.normal(size=(n_classes, per_class, 3, size, size))
    # cheap separable 3-tap smoothing -> correlated local structure
    k = np.array([0.25, 0.5, 0.25])
    for ax in (-2, -1):
        raw = sum(w * np.roll(raw, s, axis=ax)
                  for w, s in zip(k, (-1, 0, 1)))
    rms = np.sqrt((raw ** 2).mean(axis=(-3, -2, -1), keepdims=True))
    return (raw / rms).astype(np.float32)


def synth_textures(n: int, *, seed: int, world_seed: int = 1234,
                   image_size: int = 32, template_size: int = 8,
                   per_class: int = 3, n_paste: int = 4,
                   n_distract: int = 4, amp: float = 0.9,
                   distract_amp: float = 0.7, noise: float = 1.15,
                   n_classes: int = N_CLASSES
                   ) -> tuple[np.ndarray, np.ndarray]:
    """-> (x [n,3,S,S] float32 ~ pixel scale 0..255, y [n] int32).

    ``seed`` draws the samples (use different seeds for train/test);
    ``world_seed`` fixes the class template banks shared by all splits.
    """
    bank = _template_bank(np.random.default_rng(world_seed), n_classes,
                          per_class, template_size)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = rng.normal(scale=noise, size=(n, 3, image_size, image_size)
                   ).astype(np.float32)
    t = template_size
    hi = image_size - t + 1

    def paste(i: int, cls: int, count: int, amplitude: float) -> None:
        which = rng.integers(0, per_class, size=count)
        ys = rng.integers(0, hi, size=count)
        xs = rng.integers(0, hi, size=count)
        flips = rng.integers(0, 2, size=count)
        for j in range(count):
            patch = bank[cls, which[j]]
            if flips[j]:
                patch = patch[:, :, ::-1]
            x[i, :, ys[j]:ys[j] + t, xs[j]:xs[j] + t] += amplitude * patch

    for i in range(n):
        paste(i, int(y[i]), n_paste, amp)
        for _ in range(n_distract):
            other = int(rng.integers(0, n_classes - 1))
            if other >= y[i]:
                other += 1
            paste(i, other, 1, distract_amp)

    # map to the uint8-ish pixel range the CIFAR pipeline expects
    # (mean ~120, contained in [0, 255] for |z| < ~4)
    x = np.clip(x * 30.0 + 120.0, 0.0, 255.0)
    return x, y


def synth_splits(n_train: int, n_test: int, **kw
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Train/test splits over the SAME texture world, disjoint sample
    streams: (train_x, train_y, test_x, test_y)."""
    train_x, train_y = synth_textures(n_train, seed=11, **kw)
    test_x, test_y = synth_textures(n_test, seed=22, **kw)
    return train_x, train_y, test_x, test_y
