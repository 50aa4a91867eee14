"""The training feed and the device crop on the card.  Every test here is
marked ``cuda`` and skips where ``torch.cuda.is_available()`` is false;
the file imports no JAX, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda_feed.py -m cuda --noconftest

- ``DeviceFeed`` stages through pinned ring buffers and copies on its own
  stream: the rounds arrive on the card in order and byte-equal to the
  source, and a round is delivered while the consumer's stream is held.
- ``crop_mirror_mean`` on the card equals the numpy host crop bit for
  bit at the same offsets (pure data movement and one f32 subtraction).
- A trainer on the card takes rounds already on the device as they are.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.data import random_crop_mirror
from sparknet_tpu_torch.data.prefetch import device_feed
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                 TrainerConfig,
                                                 crop_mirror_mean)
from sparknet_tpu_torch.proto import load_solver_prototxt_with_net

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned staging and streams have "
                    "no CPU mode")
    return torch.device("cuda", 0)


def _rounds(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"data": rng.normal(size=(2, 4, 3, 32, 32)).astype(np.float32),
             "label": np.full((2, 4), i, np.float32)} for i in range(n)]


def test_feed_is_pinned_ordered_and_byte_equal(dev):
    src = _rounds(20)
    with device_feed(iter(src), dev, depth=2, putters=2) as feed:
        for i, batch in enumerate(feed):
            torch.cuda._sleep(2_000_000)          # a consumer that works
            for k, v in src[i].items():
                assert batch[k].device == dev
                assert batch[k].cpu().numpy().tobytes() == v.tobytes()
        bufs = [b for r in feed.rings.values() for b in r.buffers]
        assert bufs and all(b.is_pinned() for b in bufs)
        assert feed.pinned_bytes == sum(b.numel() * b.element_size()
                                        for b in bufs)
    assert i == 19


def test_feed_copies_on_its_own_stream(dev):
    go = threading.Event()
    src = _rounds(4, seed=1)

    def rounds():
        yield from src[:3]
        go.wait()
        yield src[3]

    with device_feed(rounds(), dev, depth=1, putters=1) as feed:
        assert feed.stream != torch.cuda.default_stream(dev)
        for _ in range(3):
            next(feed)
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000_000)          # ~0.5 s on the default
        go.set()
        last = next(feed)
        assert not torch.cuda.default_stream(dev).query()
        torch.cuda.synchronize()
        assert last["data"].cpu().numpy().tobytes() == src[3]["data"].tobytes()


@pytest.mark.parametrize("mean_shape", ["full", None])
def test_card_crop_equals_the_host_crop(dev, mean_shape):
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 255, (16, 3, 40, 40)).astype(np.float32)
    mean = x.mean(axis=0) if mean_shape else None
    want = random_crop_mirror(x, 33, np.random.default_rng(9), mean=mean)
    draw = np.random.default_rng(9)
    ys, xs = draw.integers(0, 8, 16), draw.integers(0, 8, 16)
    flips = draw.integers(0, 2, 16)
    got = crop_mirror_mean(
        torch.from_numpy(x).to(dev), *(torch.from_numpy(a).to(dev)
                                       for a in (ys, xs, flips)), 33,
        None if mean is None else torch.from_numpy(mean).to(dev))
    assert got.is_cuda
    assert got.cpu().numpy().tobytes() == want.tobytes()


def test_trainer_takes_device_rounds_as_they_are(dev):
    sp = load_solver_prototxt_with_net(
        'base_lr: 0.01\nmomentum: 0.9\nlr_policy: "fixed"\n', lenet(8, 8))
    rng = np.random.default_rng(2)
    batches = {"data": rng.normal(size=(2, 8, 1, 28, 28)).astype(np.float32),
               "label": rng.integers(0, 10, (2, 8)).astype(np.float32)}
    host = DistributedTrainer(sp, 2, TrainerConfig(tau=2), device=dev)
    staged = DistributedTrainer(sp, 2, TrainerConfig(tau=2), device=dev)
    loss = host.train_round(batches)
    on_card = {k: torch.from_numpy(v).to(dev) for k, v in batches.items()}
    assert staged.train_round(on_card) == pytest.approx(loss, rel=1e-6)


DUMMY_ONLY = """
layer { name: "d" type: "DummyData" top: "x" top: "label"
  dummy_data_param { shape { dim: 4 dim: 3 } shape { dim: 4 }
    data_filler { type: "gaussian" std: 2 } data_filler { type: "constant" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "x" bottom: "label" }
"""


def test_dummy_data_net_runs_on_the_card(dev):
    """A net of DummyData and a loss only, with no input and no param to
    take a device from: its tops are drawn on the CPU and land on the
    card, and so does its loss; a Solver on a DummyData train net steps
    and tests there."""
    from sparknet_tpu_torch.graph.net import Net
    from sparknet_tpu_torch.proto import NetState, Phase, load_net_prototxt
    from sparknet_tpu_torch.solvers import Solver
    net = Net(load_net_prototxt(DUMMY_ONLY), NetState(Phase.TRAIN))
    gen = torch.Generator().manual_seed(0)
    out = net.forward({}, {}, generator=gen, device=dev)
    assert out.loss.device.type == "cuda"
    cpu = net.forward({}, {}, generator=torch.Generator().manual_seed(0))
    assert cpu.loss.device.type == "cpu"
    torch.testing.assert_close(out.loss.cpu(), cpu.loss)
    txt = DUMMY_ONLY.replace(
        'layer { name: "loss"',
        'layer { name: "ip" type: "InnerProduct" bottom: "x" top: "ip"\n'
        '  inner_product_param { num_output: 3 } }\n'
        'layer { name: "loss"').replace('bottom: "x" bottom: "label"',
                                        'bottom: "ip" bottom: "label"')
    sp = load_solver_prototxt_with_net(
        'base_lr: 0.1\nlr_policy: "fixed"\ntest_iter: 1\n',
        load_net_prototxt(txt))
    solver = Solver(sp, device=dev)
    assert np.isfinite(solver.step(2))
    assert np.isfinite(solver.test(1)["loss"])
