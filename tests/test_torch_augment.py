"""``ops/augment.py`` and ``Solver.set_augment`` against the JAX package,
on the CPU.

- ``apply`` equals the JAX ``apply`` bit for bit at injected offsets
  (the draws cannot match: a CPU ``torch.Generator`` against
  ``jax.random``) on seeded uint8 batches, for train and test specs, a
  per-channel and a full-size mean, with and without crop, mirror and
  scale; ``from_transform_param`` (a prototxt message, a dict, a
  ``mean_file``) and ``out_shape`` equal the JAX ones.
- ``augment_batch_host`` (numpy) equals ``augment_batch`` at the same
  generator state; a test spec draws nothing.
- The Solver on lenet: ``set_augment(device=True)`` and
  ``device=False`` give the same losses bit for bit (``iter_size`` 2),
  and against the JAX Solver, with a spec that draws nothing and the
  weights moved through a ``.caffemodel``, within 1e-5 relative.
- A snapshot and restore mid-run draw the crops the uninterrupted run
  draws (the augment generator rides in the npz).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.models import lenet as jax_lenet
from sparknet_tpu.ops import augment as jaug
from sparknet_tpu.proto import caffemodel as jax_cm
from sparknet_tpu.proto import load_net_prototxt as jax_load_net
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_sp
from sparknet_tpu.proto.caffe_pb import Phase as JaxPhase
from sparknet_tpu.solvers import Solver as JaxSolver
from sparknet_tpu_torch.data.transforms import augment_batch_host
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.ops import augment as aug
from sparknet_tpu_torch.proto import (load_net_prototxt,
                                      load_solver_prototxt_with_net)
from sparknet_tpu_torch.proto.caffe_pb import Phase
from sparknet_tpu_torch.proto.caffemodel import save_mean_binaryproto
from sparknet_tpu_torch.solvers.solver import Solver
from tests.test_torch_solver import _host
from tests.torch_threads import one_torch_thread  # noqa: F401

N, C, H, W = 6, 3, 12, 14
SPECS = {   # crop, mirror, scale, train
    "train_crop_mirror_scale": (8, True, 0.00390625, True),
    "test_center_crop": (8, True, 0.017, False),
    "train_no_crop_mirror": (0, True, 1.0, True),
    "no_crop_scale": (0, False, 0.3, True),
}
MEANS = {"none": None,
         "per_channel": np.array([[[104.0]], [[117.0]], [[123.5]]],
                                 np.float32),
         "full_size": (120 + 30 * np.random.default_rng(9).normal(
             size=(C, H, W))).astype(np.float32)}


def bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a, np.float32)).tobytes()


@pytest.mark.parametrize("mean", list(MEANS))
@pytest.mark.parametrize("spec", list(SPECS))
def test_apply_equals_the_jax_apply_bit_for_bit(spec, mean):
    crop, mirror, scale, train = SPECS[spec]
    rng = np.random.default_rng(len(spec) * 7 + len(mean))
    imgs = rng.integers(0, 256, (N, C, H, W)).astype(np.uint8)
    ys = rng.integers(0, H - crop + 1, N).astype(np.int32)
    xs = rng.integers(0, W - crop + 1, N).astype(np.int32)
    flips = rng.integers(0, 2, N).astype(np.int32)
    args = (crop, mirror, MEANS[mean], scale, train)
    want = jaug.apply(jnp.asarray(imgs), jnp.asarray(ys), jnp.asarray(xs),
                      jnp.asarray(flips), jaug.AugmentSpec(*args))
    got = aug.apply(torch.from_numpy(imgs), torch.from_numpy(ys),
                    torch.from_numpy(xs), torch.from_numpy(flips),
                    aug.AugmentSpec(*args))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tuple(want.shape) == aug.out_shape(
        imgs.shape, aug.AugmentSpec(*args))
    assert bits(got) == bits(want)


def test_a_mirror_along_the_wrong_axis_is_told_apart():
    """The check above would see a vertical mirror: the flipped samples'
    bytes differ from the JAX ``apply``'s."""
    crop, mirror, scale, train = SPECS["train_crop_mirror_scale"]
    spec = aug.AugmentSpec(crop, mirror, None, scale, train)
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (N, C, H, W)).astype(np.uint8)
    ys = xs = np.zeros(N, np.int32)
    flips = np.ones(N, np.int32)
    want = jaug.apply(jnp.asarray(imgs), ys, xs, flips,
                      jaug.AugmentSpec(crop, mirror, None, scale, train))
    wrong = aug.apply(torch.from_numpy(imgs), ys, xs, np.zeros(N, np.int32),
                      spec).flip(-2)
    assert bits(wrong) != bits(want)


TRANSFORM_NET = """
layer { name: "d" type: "Data" top: "data" top: "label"
  data_param { source: "x" batch_size: 2 }
  transform_param { crop_size: 5 mirror: true scale: 0.5
    mean_value: 1 mean_value: 2 mean_value: 3 } }
"""


def test_from_transform_param_and_out_shape_equal_the_jax_ones(tmp_path):
    lp = load_net_prototxt(TRANSFORM_NET).layer[0].sub("transform_param")
    jlp = jax_load_net(TRANSFORM_NET).layer[0].sub("transform_param")
    mean_file = str(tmp_path / "mean.binaryproto")
    save_mean_binaryproto(mean_file, MEANS["full_size"])
    cases = [(lp, jlp), ({"crop_size": 4, "mean_value": 7.5},
                         {"crop_size": 4, "mean_value": 7.5}),
             ({"mean_file": mean_file, "mirror": True},
              {"mean_file": mean_file, "mirror": True}), ({}, {})]
    for phase, jphase in ((Phase.TRAIN, JaxPhase.TRAIN),
                          (Phase.TEST, JaxPhase.TEST)):
        for ours, theirs in cases:
            got = aug.AugmentSpec.from_transform_param(ours, phase)
            want = jaug.AugmentSpec.from_transform_param(theirs, jphase)
            assert (got.crop, got.mirror, got.scale, got.train) == (
                want.crop, want.mirror, want.scale, want.train)
            if want.mean is None:
                assert got.mean is None
            else:
                assert got.mean.shape == want.mean.shape
                assert bits(got.mean) == bits(want.mean)
            for shape in ((3, 3, 9, 9), (1, 3, 5, 5)):
                assert aug.out_shape(shape, got) == jaug.out_shape(shape,
                                                                   want)


@pytest.mark.parametrize("spec", list(SPECS))
def test_host_augment_equals_the_device_op_at_the_same_draws(spec):
    crop, mirror, scale, train = SPECS[spec]
    s = aug.AugmentSpec(crop, mirror, MEANS["full_size"], scale, train)
    imgs = np.random.default_rng(5).integers(0, 256, (N, C, H, W)
                                             ).astype(np.uint8)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator(
    ).manual_seed(3)
    host = augment_batch_host(imgs, g1, s)
    dev = aug.augment_batch(torch.from_numpy(imgs), g2, s)
    assert bits(host) == bits(dev)
    assert torch.equal(g1.get_state(), g2.get_state())
    if not train:   # the test phase draws nothing
        assert torch.equal(g1.get_state(),
                           torch.Generator().manual_seed(3).get_state())


SOLVER = 'base_lr: 0.01\nmomentum: 0.9\nlr_policy: "fixed"\n'


def raw_batches(n: int, size: int = 32, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"data": rng.integers(0, 256, (4, 1, size, size)
                                  ).astype(np.uint8),
             "label": rng.integers(0, 10, 4).astype(np.float32)}
            for _ in range(n)]


SPEC = aug.AugmentSpec(crop=28, mirror=True, mean=np.full((1, 1, 1), 33.0,
                                                          np.float32),
                       scale=0.00390625, train=True)


def run(solver: Solver, batches: list, spec=SPEC, device=True) -> list:
    solver.set_augment(spec, device=device)
    solver.set_train_data(iter(batches))
    return [solver.step(1) for _ in range(len(batches) //
                                          solver.sp.iter_size)]


def test_set_augment_on_device_and_host_give_the_same_losses():
    sp = load_solver_prototxt_with_net(SOLVER + "iter_size: 2\n",
                                       lenet(4, 4))
    batches = raw_batches(8)
    on = run(Solver(sp, device="cpu"), batches, device=True)
    off = run(Solver(sp, device="cpu"), batches, device=False)
    assert on == off
    plain = run(Solver(sp, device="cpu"), [
        {"data": b["data"][:, :, 2:30, 2:30].astype(np.float32),
         "label": b["label"]}
        for b in batches], spec=None)
    assert on != plain   # the crops moved, and the values are scaled


@pytest.mark.parametrize("spec", [
    aug.AugmentSpec(crop=28, mirror=True, mean=np.full((1, 1, 1), 33.0,
                                                       np.float32),
                    scale=0.00390625, train=False),
    aug.AugmentSpec(crop=0, mean=np.full((1, 1, 1), 33.0, np.float32),
                    scale=0.00390625)], ids=["test_phase_crop", "no_crop"])
def test_solver_tracks_the_jax_solver_with_a_spec_that_draws_nothing(
        spec, tmp_path):
    size = 32 if spec.crop else 28
    batches = raw_batches(6, size, seed=2)
    jsolver = JaxSolver(jax_sp(SOLVER, jax_lenet(4, 4)), seed=0)
    path = str(tmp_path / "init.caffemodel")
    jax_cm.save_caffemodel(path, _host(jsolver.params), jsolver.sp.net_param)
    solver = Solver(load_solver_prototxt_with_net(SOLVER, lenet(4, 4)),
                    device="cpu")
    solver.load_weights(path)
    jsolver.set_augment(jaug.AugmentSpec(*spec))
    jsolver.set_train_data(iter(batches))
    want = [jsolver.step(1) for _ in batches]
    got = run(solver, batches, spec)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_snapshot_and_restore_resume_the_same_crops(tmp_path):
    sp = load_solver_prototxt_with_net(SOLVER, lenet(4, 4))
    batches = raw_batches(6, seed=4)
    whole = Solver(sp, device="cpu")
    want = run(whole, batches)
    first = Solver(sp, device="cpu")
    run(first, batches[:3])
    first.snapshot(str(tmp_path / "s.npz"))
    resumed = Solver(sp, seed=5, device="cpu")
    resumed.restore(str(tmp_path / "s.npz"))
    assert run(resumed, batches[3:]) == want[3:]
    # a restore that loses the augment generator draws other crops
    reset = Solver(sp, seed=5, device="cpu")
    reset.restore(str(tmp_path / "s.npz"))
    reset.augment_generator.manual_seed(0)
    assert run(reset, batches[3:]) != want[3:]
