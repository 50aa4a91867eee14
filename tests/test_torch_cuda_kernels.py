"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.  The file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

Tolerances: f32 at rtol 1e-5, atol 1e-6; bf16 within one bf16 ulp (both
sides do f32 math and round once).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.ops import cuda_kernels as ck

ALPHA, BETA, K = 0.3, 0.75, 1.0

pytestmark = pytest.mark.cuda


def _ids(case):
    shape, size, relu = case
    return f"{'x'.join(map(str, shape))}-n{size}-{'relu' if relu else 'lrn'}"


def _input(shape, seed=0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * 2.0).astype(
        np.float32)


def _assert_within_bf16_ulp(got: np.ndarray, want: np.ndarray) -> None:
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    err = np.abs(got - want)
    assert (err <= ulp).all(), (
        f"{int((err > ulp).sum())} elements beyond 1 bf16 ulp, "
        f"max |err| {err.max():.3e}")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


GPU_CASES = [((2, 6, 5, 7), 5, False), ((1, 8, 3, 3), 3, True),
             ((2, 16, 5, 5), 4, False), ((2, 16, 5, 5), 4, True),
             ((4, 96, 27, 27), 5, False), ((4, 256, 13, 13), 5, False),
             ((2, 192, 56, 56), 5, True),
             # batch 1 (the shortest chunk), the sized instantiations 3/4/5
             # on a chunk boundary, and sizes the generic form takes
             ((1, 96, 27, 27), 5, False), ((1, 256, 13, 13), 5, True),
             ((3, 33, 4, 5), 3, False), ((3, 33, 4, 5), 4, True),
             ((3, 33, 4, 5), 5, False), ((2, 19, 3, 7), 7, False),
             ((2, 19, 3, 7), 2, True), ((2, 19, 3, 7), 1, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", GPU_CASES, ids=_ids)
def test_cuda_kernel_matches_plain(case, dtype):
    _need_cuda()
    shape, size, relu = case
    x = torch.from_numpy(_input(shape)).to("cuda", dtype)
    before = ck.launch_counts["lrn_across_channels"]
    got = ck.lrn_across_channels(x, size, ALPHA, BETA, K, relu=relu)
    want = ck.lrn_across_channels_reference(x, size, ALPHA, BETA, K, relu)
    torch.cuda.synchronize()
    assert ck.launch_counts["lrn_across_channels"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
    else:
        _assert_within_bf16_ulp(got.float().cpu().numpy(),
                                want.float().cpu().numpy())


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    _need_cuda()
    x = torch.ones((2, 4, 3, 3), device="cuda")
    with pytest.raises(TypeError):
        ck.lrn_across_channels(x.half(), 5, ALPHA, BETA, K)
    with pytest.raises(ValueError, match="contiguous"):
        ck.lrn_across_channels(x.transpose(2, 3), 5, ALPHA, BETA, K)
    with pytest.raises(ValueError, match="N, C, H, W"):
        ck.lrn_across_channels(x[0], 5, ALPHA, BETA, K)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_engine_on_the_card_goes_through_the_kernel(dtype):
    """CaffeNet at a 67x67 crop served on the card: two LRN launches per
    dispatched batch, and probabilities that match the port's CPU forward
    on the same weights (f32: rtol 1e-4, atol 1e-6 with TF32 off; bf16:
    atol 2e-2, since cuDNN and the CPU round to bf16 in other places)."""
    _need_cuda()
    from sparknet_tpu_torch.models import caffenet
    from sparknet_tpu_torch.parallel.serving import (
        InferenceEngine, LoadedModel, ModelHouse, ServeConfig)

    cfg = ServeConfig(batch_shapes=(1, 4), max_delay_ms=50.0, dtype=dtype)
    house = ModelHouse(cfg, device="cuda")
    lm = LoadedModel("caffenet67", caffenet(1, 1, crop=67), cfg,
                     device="cuda")
    house._models[lm.name] = lm
    xs = [_input((3, 67, 67), seed=i) for i in range(6)]
    ck.reset_launch_counts()
    with InferenceEngine(house, cfg) as eng:
        res = [f.result(30.0) for f in [eng.submit(lm.name, x) for x in xs]]
        dispatches = eng.stats()["dispatches"]
    assert ck.launch_counts["lrn_across_channels"] == 2 * dispatches
    cpu_params = {k: [b.cpu() for b in v] for k, v in lm._fwd_params.items()}
    with torch.inference_mode():
        want = lm.net.apply(cpu_params, {"data": torch.from_numpy(
            np.stack(xs))})["prob"].float().numpy()
    got = np.stack([r.probs for r in res])
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2)


# ---------------------------------------------------------------------------
# The training kernels: the LRN forward with scale, its backward, and the
# MAX-pool backward, each against its plain version on the same card
# tensors.  The LRN backward in f32 at rtol 1e-4 (its powf calls may
# differ by an ulp from torch's, and the difference of two terms can
# cancel); the pool backward at rtol 1e-4, atol 1e-6 (overlapping windows
# add in another order).
# ---------------------------------------------------------------------------

def _assert_close_for(dtype, got, want, rtol=1e-5):
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=rtol, atol=1e-6)
    else:
        _assert_within_bf16_ulp(got.float().cpu().numpy(),
                                want.float().cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", GPU_CASES, ids=_ids)
def test_cuda_train_lrn_kernels_match_plain(case, dtype):
    _need_cuda()
    shape, size, relu = case
    x = torch.from_numpy(_input(shape)).to("cuda", dtype)
    dy = torch.from_numpy(_input(shape, seed=1)).to("cuda", dtype)
    before = dict(ck.launch_counts)
    y, scale = ck.lrn_across_channels_fwd(x, size, ALPHA, BETA, K, relu)
    dx = ck.lrn_across_channels_bwd(x, scale, dy, size, ALPHA, BETA, relu)
    wy, wscale = ck.lrn_across_channels_fwd_reference(x, size, ALPHA, BETA,
                                                      K, relu)
    wdx = ck.lrn_across_channels_bwd_reference(x, scale, dy, size, ALPHA,
                                               BETA, relu)
    torch.cuda.synchronize()
    assert ck.launch_counts["lrn_across_channels_fwd"] == \
        before["lrn_across_channels_fwd"] + 1
    assert ck.launch_counts["lrn_across_channels_bwd"] == \
        before["lrn_across_channels_bwd"] + 1
    assert y.dtype == scale.dtype == dx.dtype == dtype
    _assert_close_for(dtype, y, wy)
    _assert_close_for(dtype, scale, wscale)
    _assert_close_for(dtype, dx, wdx, rtol=1e-4)
    # the training forward writes what the inference kernel writes
    torch.testing.assert_close(
        y, ck.lrn_across_channels(x, size, ALPHA, BETA, K, relu),
        rtol=0, atol=0)


POOL_GPU_CASES = [((2, 3, 13, 13), 3, 2, 0), ((2, 4, 14, 14), 3, 1, 1),
                  ((1, 3, 13, 13), 3, 2, 1), ((1, 2, 7, 7), 5, 3, 2),
                  ((1, 2, 17, 17), 2, 3, 1), ((4, 96, 55, 55), 3, 2, 0),
                  # banded planes: VGG's pool1, a 224x224 3x3 stride-2
                  # pad-1 pool, and a stride-1 pool on a plane whose one-row
                  # band opts in to more than 48 KB of shared memory
                  ((1, 8, 224, 224), 2, 2, 0), ((1, 4, 224, 224), 3, 2, 1),
                  ((1, 2, 9, 5000), 3, 1, 1),
                  # packed planes with a partial last group
                  ((64, 251, 13, 13), 3, 2, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", POOL_GPU_CASES,
                         ids=lambda c: "x".join(map(str, c[0]))
                         + f"-k{c[1]}s{c[2]}p{c[3]}")
def test_cuda_max_pool_bwd_matches_plain_on_ties(case, dtype):
    _need_cuda()
    from sparknet_tpu_torch.ops.vision import pool_output_size
    shape, k, s, p = case
    rng = np.random.default_rng(0)
    x = np.round(2 * np.maximum(rng.normal(size=shape), 0)) / 2
    oh, ow = pool_output_size(shape[2], shape[3], k, k, s, s, p, p)
    dy = rng.normal(size=shape[:2] + (oh, ow))
    x = torch.from_numpy(x).to("cuda", dtype)
    dy = torch.from_numpy(dy).to("cuda", dtype)
    before = ck.launch_counts["max_pool_bwd"]
    got = ck.max_pool_bwd(x, dy, k, k, s, s, p, p, oh, ow)
    want = ck.max_pool_bwd_reference(x, dy, k, k, s, s, p, p, oh, ow)
    torch.cuda.synchronize()
    assert ck.launch_counts["max_pool_bwd"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_lrn_forward_takes_a_batch_above_65535(dtype):
    """The positions are flattened over (n, p), so the batch is no grid
    dimension: 70,000 images of a 3-channel 2x2 plane."""
    _need_cuda()
    x = torch.from_numpy(_input((70_000, 3, 2, 2))).to("cuda", dtype)
    got = ck.lrn_across_channels(x, 3, ALPHA, BETA, K)
    y, scale = ck.lrn_across_channels_fwd(x, 3, ALPHA, BETA, K)
    want, wscale = ck.lrn_across_channels_fwd_reference(x, 3, ALPHA, BETA,
                                                        K)
    torch.cuda.synchronize()
    _assert_close_for(dtype, got, want)
    _assert_close_for(dtype, scale, wscale)
    torch.testing.assert_close(y, got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_lrn_backward_takes_a_batch_above_65535(dtype):
    """The backward's positions are flattened over (n, p) too: 70,000
    images of a 3-channel 2x2 plane, in blocks of one warp."""
    _need_cuda()
    x = torch.from_numpy(_input((70_000, 3, 2, 2))).to("cuda", dtype)
    dy = torch.from_numpy(_input((70_000, 3, 2, 2), seed=1)).to("cuda",
                                                                dtype)
    _, scale = ck.lrn_across_channels_fwd(x, 3, ALPHA, BETA, K)
    got = ck.lrn_across_channels_bwd(x, scale, dy, 3, ALPHA, BETA)
    want = ck.lrn_across_channels_bwd_reference(x, scale, dy, 3, ALPHA,
                                                BETA)
    torch.cuda.synchronize()
    _assert_close_for(dtype, got, want, rtol=1e-4)


# The backward at the edges of its chunks and blocks: one channel, fewer
# channels than the window, 13 channels (four warps, the last with one
# channel), 37 (three blocks, the last one warp with one channel), at
# the sized windows and at 7, the generic form
LRN_BWD_EDGE_CASES = [(shape, size, relu)
                      for shape in ((2, 1, 5, 9), (2, 3, 5, 9),
                                    (3, 13, 5, 9), (2, 37, 3, 11))
                      for size in (3, 4, 5, 7) for relu in (False, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", LRN_BWD_EDGE_CASES, ids=_ids)
def test_cuda_lrn_bwd_matches_plain_at_chunk_and_block_edges(case, dtype):
    _need_cuda()
    shape, size, relu = case
    x = torch.from_numpy(50 * _input(shape)).to("cuda", dtype)
    dy = torch.from_numpy(50 * _input(shape, seed=1)).to("cuda", dtype)
    _, scale = ck.lrn_across_channels_fwd(x, size, ALPHA, BETA, K, relu)
    got = ck.lrn_across_channels_bwd(x, scale, dy, size, ALPHA, BETA, relu)
    want = ck.lrn_across_channels_bwd_reference(x, scale, dy, size, ALPHA,
                                                BETA, relu)
    torch.cuda.synchronize()
    assert not torch.isnan(got.float()).any()
    _assert_close_for(dtype, got, want, rtol=1e-4)


@pytest.mark.parametrize("size", [3, 4, 5, 7])
def test_cuda_lrn_bwd_any_warps_per_block_matches_plain(size):
    """The entry point takes 1 to 8 warps a block, whatever the plan
    picks: each gives the plain version's dx on 37 channels."""
    _need_cuda()
    shape = (3, 37, 5, 9)
    x = torch.from_numpy(50 * _input(shape)).to("cuda")
    dy = torch.from_numpy(50 * _input(shape, seed=1)).to("cuda")
    _, scale = ck.lrn_across_channels_fwd(x, size, ALPHA, BETA, K)
    want = ck.lrn_across_channels_bwd_reference(x, scale, dy, size, ALPHA,
                                                BETA)
    for warps in range(1, ck.LRN_BWD_MAX_WARPS + 1):
        dx = torch.full_like(x, float("nan"))
        ck._launch("lrn_across_channels_bwd", "lrn_bwd",
                   "sparknet_lrn_across_channels_bwd", x.device,
                   x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                   dx.data_ptr(), 3, 37, 45, size,
                   2.0 * ALPHA * BETA / size, BETA, 0, 0, warps)
        torch.cuda.synchronize()
        _assert_close_for(torch.float32, dx, want, rtol=1e-4)


def test_cuda_max_pool_bwd_refuses_a_plan_short_of_shared_memory():
    """The entry point recomputes the shared bytes a plan needs and
    refuses one that gives less, before launching."""
    _need_cuda()
    x = torch.ones((1, 1, 13, 13), device="cuda")
    dy = torch.ones((1, 1, 6, 6), device="cuda")
    dx = torch.empty_like(x)
    plan = ck.max_pool_bwd_plan(1, 13, 13, 3, 3, 2, 2, 0, 0, 6, 6, 4)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ck._launch("max_pool_bwd", "maxpool_bwd", "sparknet_max_pool_bwd",
                   x.device, x.data_ptr(), dy.data_ptr(), dx.data_ptr(), 1,
                   13, 13, 3, 3, 2, 2, 0, 0, 6, 6, plan.planes_per_block,
                   plan.band_rows, plan.smem_bytes - 4, 0)


def test_cuda_train_wrappers_refuse_what_the_kernels_do_not_take():
    _need_cuda()
    x = torch.ones((2, 4, 5, 5), device="cuda")
    _, scale = ck.lrn_across_channels_fwd(x, 5, ALPHA, BETA, K)
    with pytest.raises(ValueError, match="dtype|float32|bfloat16"):
        ck.lrn_across_channels_bwd(x, scale.bfloat16(), x, 5, ALPHA, BETA)
    with pytest.raises(ValueError, match="shape"):
        ck.lrn_across_channels_bwd(x, scale, x[:1].contiguous(), 5, ALPHA,
                                   BETA)
    with pytest.raises(ValueError, match="output"):
        ck.max_pool_bwd(x, torch.ones((2, 4, 3, 3), device="cuda"), 3, 3,
                        2, 2, 0, 0, 2, 2)
    with pytest.raises(ValueError, match="window"):
        ck.max_pool_bwd(x, torch.ones((2, 4, 9, 9), device="cuda"), 3, 3,
                        1, 1, 2, 2, 9, 9)


def test_cuda_training_step_goes_through_every_kernel():
    """One local-SGD round of CaffeNet at a 67x67 crop on the card: 2 LRN
    forward and backward launches and 3 pool-backward launches per
    worker step, and a loss that matches the CPU round from the same
    weights, batches and Dropout masks (TF32 off)."""
    _need_cuda()
    from sparknet_tpu_torch.models import caffenet
    from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                     TrainerConfig)
    from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
    sp = load_solver_prototxt_with_net(
        'base_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n',
        caffenet(4, 4, crop=67))
    rng = np.random.default_rng(0)
    batches = {"data": (50 * rng.normal(size=(2, 4, 3, 67, 67))).astype(
        np.float32), "label": rng.integers(0, 1000, (2, 4)).astype(
        np.float32)}
    losses = {}
    for dev in ("cuda", "cpu"):
        tr = DistributedTrainer(sp, 2, TrainerConfig(tau=2), seed=0,
                                device=dev)
        ck.reset_launch_counts()
        losses[dev] = tr.train_round(batches)
        if dev == "cuda":
            assert ck.launch_counts == {
                "lrn_across_channels": 0, "lrn_across_channels_fwd": 8,
                "lrn_across_channels_bwd": 8, "max_pool_bwd": 12,
                "ycc_to_rgb": 0, "resize_bilinear": 0}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# ---------------------------------------------------------------------------
# The kernels at the shapes GoogLeNet's and the CIFAR nets' training paths
# give them (batch 32 for GoogLeNet, CifarApp's 100 for CIFAR)
# ---------------------------------------------------------------------------

# GoogLeNet's nine 3/1/1 inception pools (B4), its 3/2 pool1 on 112x112
# planes, which the kernel cuts into bands (B5), and cifar10's pool1
ZOO_POOL_CASES = [
    *(((32, c, hw, hw), 3, 1, 1)
      for c, hw in ((192, 28), (256, 28), (480, 14), (512, 14), (512, 14),
                    (512, 14), (528, 14), (832, 7), (832, 7))),
    ((32, 64, 112, 112), 3, 2, 0),
    ((100, 32, 32, 32), 3, 2, 0)]
ZOO_LRN_CASES = [((32, 64, 56, 56), 5, False), ((32, 192, 56, 56), 5, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(set(ZOO_POOL_CASES)),
                         ids=lambda c: "x".join(map(str, c[0]))
                         + f"-k{c[1]}s{c[2]}p{c[3]}")
def test_cuda_max_pool_bwd_matches_plain_at_zoo_shapes(case, dtype):
    test_cuda_max_pool_bwd_matches_plain_on_ties(case, dtype)
    shape, k, s, p = case
    if shape[2] == 112:
        from sparknet_tpu_torch.ops.vision import pool_output_size
        oh, ow = pool_output_size(112, 112, k, k, s, s, p, p)
        plan = ck.max_pool_bwd_plan(shape[0] * shape[1], 112, 112, k, k, s,
                                    s, p, p, oh, ow, torch.tensor(
                                        [], dtype=dtype).element_size())
        assert plan.bands > 1, plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ZOO_LRN_CASES, ids=_ids)
def test_cuda_lrn_kernels_match_plain_at_googlenet_norms(case, dtype):
    test_cuda_train_lrn_kernels_match_plain(case, dtype)
    test_cuda_kernel_matches_plain(case, dtype)


@pytest.mark.parametrize("model", ["googlenet", "cifar10_full"])
def test_cuda_zoo_training_step_launches_its_kernels(model):
    """One local-SGD step of full-width GoogLeNet (batch 2) or
    cifar10_full (batch 4) on the card: per worker step GoogLeNet launches
    the LRN forward and backward twice each and the pool backward 13
    times (4 strided, 9 stride-1); cifar10_full the pool backward once
    (its AVE pools and WITHIN_CHANNEL LRNs are library work).  The loss
    matches the CPU step from the same weights, batch and Dropout masks
    (TF32 off) at rtol 1e-4."""
    _need_cuda()
    from sparknet_tpu_torch.models import cifar10_full, googlenet
    from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                     TrainerConfig)
    from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
    if model == "googlenet":
        net, shape, classes = googlenet(2, 2), (1, 2, 3, 224, 224), 1000
        want = {"lrn_across_channels": 0, "lrn_across_channels_fwd": 2,
                "lrn_across_channels_bwd": 2, "max_pool_bwd": 13,
                "ycc_to_rgb": 0, "resize_bilinear": 0}
    else:
        net, shape, classes = cifar10_full(4, 4), (1, 4, 3, 32, 32), 10
        want = {"lrn_across_channels": 0, "lrn_across_channels_fwd": 0,
                "lrn_across_channels_bwd": 0, "max_pool_bwd": 1,
                "ycc_to_rgb": 0, "resize_bilinear": 0}
    sp = load_solver_prototxt_with_net(
        'base_lr: 0.001\nmomentum: 0.9\nweight_decay: 0.004\n', net)
    rng = np.random.default_rng(0)
    batches = {"data": (50 * rng.normal(size=shape)).astype(np.float32),
               "label": rng.integers(0, classes, shape[:2]).astype(
                   np.float32)}
    losses = {}
    for dev in ("cuda", "cpu"):
        tr = DistributedTrainer(sp, 1, TrainerConfig(tau=1), seed=0,
                                device=dev)
        ck.reset_launch_counts()
        losses[dev] = tr.train_round(batches)
        if dev == "cuda":
            assert ck.launch_counts == want
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# ---------------------------------------------------------------------------
# The pool backward under SPP's MAX levels and on cifar10_full_sigmoid_bn's
# training path (batch 100: its pool1 is ZOO_POOL_CASES' last case)
# ---------------------------------------------------------------------------

SPP_SHAPES = [(2, 3, 13, 13), (4, 8, 10, 7), (100, 64, 4, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SPP_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_spp_max_levels_launch_the_pool_backward(shape, dtype):
    """A 3-level MAX SPP on the card: its backward launches the kernel
    once a level, each level's geometry (kernel = stride = ceil(dim /
    bins), Caffe's padding) against the plain version, and the layer's
    input gradient equals the CPU's."""
    _need_cuda()
    from sparknet_tpu_torch.models.dsl import layer
    from sparknet_tpu_torch.ops import get_layer_impl
    from sparknet_tpu_torch.ops.vision import SPPLayer
    lp = layer("spp", "SPP", ["x"], ["y"], spp_param={"pyramid_height": 3})
    rng = np.random.default_rng(1)
    x0 = np.round(2 * rng.normal(size=shape)) / 2
    for bins, kh, kw, ph, pw in SPPLayer.levels(lp, shape):
        x = torch.from_numpy(x0).to("cuda", dtype)
        dy = torch.from_numpy(rng.normal(size=shape[:2] + (bins, bins))).to(
            "cuda", dtype)
        got = ck.max_pool_bwd(x, dy, kh, kw, kh, kw, ph, pw, bins, bins)
        want = ck.max_pool_bwd_reference(x, dy, kh, kw, kh, kw, ph, pw,
                                         bins, bins)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=1e-4,
                                   atol=1e-6)
    grads = {}
    for dev in ("cuda", "cpu"):
        x = torch.from_numpy(x0).to(dev, dtype).requires_grad_()
        ck.reset_launch_counts()
        (y,) = get_layer_impl("SPP").apply(lp, [], [x], True)
        (grads[dev],) = torch.autograd.grad(y.sum(), x)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert ck.launch_counts["max_pool_bwd"] == 3
    np.testing.assert_allclose(grads["cuda"].float().cpu().numpy(),
                               grads["cpu"].float().numpy(), rtol=1e-4,
                               atol=1e-6)


BN_STEP_NET = """
name: "bn_step"
layer { name: "data" type: "Input" top: "data"
  input_param { shape { dim: 100 dim: 3 dim: 32 dim: 32 } } }
layer { name: "label" type: "Input" top: "label"
  input_param { shape { dim: 100 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 32 pad: 2 kernel_size: 5 bias_term: false
    weight_filler { type: "gaussian" std: 0.01 } } }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "bn1" type: "BatchNorm" bottom: "pool1" top: "bn1" }
layer { name: "sig1" type: "Sigmoid" bottom: "bn1" top: "sig1" }
layer { name: "pool2" type: "Pooling" bottom: "sig1" top: "pool2"
  pooling_param { pool: AVE kernel_size: 3 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool2" top: "ip1"
  inner_product_param { num_output: 10
    weight_filler { type: "gaussian" std: 0.01 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip1" bottom: "label" }
"""


def test_cuda_batchnorm_step_launches_the_pool_backward_once():
    """cifar10_full_sigmoid_bn's first stage at batch 100 (its MAX pool1,
    then BatchNorm) through one Solver step on the card: one pool
    backward, no LRN kernel; the loss and the running statistics equal
    the CPU's (TF32 off)."""
    _need_cuda()
    from sparknet_tpu_torch.proto import (load_net_prototxt,
                                          load_solver_prototxt_with_net)
    from sparknet_tpu_torch.solvers import Solver
    sp = load_solver_prototxt_with_net('base_lr: 0.001\nmomentum: 0.9\n',
                                       load_net_prototxt(BN_STEP_NET))
    rng = np.random.default_rng(2)
    batch = {"data": (50 * rng.normal(size=(100, 3, 32, 32))).astype(
        np.float32), "label": rng.integers(0, 10, 100).astype(np.float32)}
    out = {}
    for dev in ("cuda", "cpu"):
        s = Solver(sp, seed=0, device=dev)
        s.set_train_data(iter([batch]))
        ck.reset_launch_counts()
        out[dev] = (s.step(1), [b.cpu() for b in s.params["bn1"]])
        if dev == "cuda":
            assert ck.launch_counts["max_pool_bwd"] == 1
            assert not any(v for k, v in ck.launch_counts.items()
                           if k.startswith("lrn"))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_cuda_cmyk_jpeg_decodes_within_the_nvjpeg_bound_of_pil():
    """The committed Adobe CMYK fixture through nvJPEG's unchanged
    components and ``cmyk_to_rgb`` on the card: within 2 of the PIL
    pixels the manifest holds, mean under 0.05."""
    _need_cuda()
    import json
    import pathlib
    from sparknet_tpu_torch.data import jpeg
    d = (pathlib.Path(__file__).resolve().parent.parent / "sparknet_tpu_torch"
         / "data" / "png_fixtures")
    e = json.loads((d / "manifest.json").read_text())["images"][
        "cmyk_adobe.jpg"]
    got = jpeg.decode_cmyk((d / "cmyk_adobe.jpg").read_bytes(), "cuda")
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    diff = np.abs(got.cpu().numpy().astype(int)
                  - np.load(d / e["rgb_pixels"]).astype(int))
    assert diff.max() <= 2 and diff.mean() < 0.05, (diff.max(), diff.mean())


CLASSIFY_NET = """
input: "data" input_shape { dim: 1 dim: 3 dim: 16 dim: 16 }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1
    weight_filler { type: "xavier" } } }
layer { name: "norm1" type: "LRN" bottom: "conv" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "norm2" type: "LRN" bottom: "norm1" top: "norm2"
  lrn_param { local_size: 3 alpha: 0.01 beta: 0.75 } }
layer { name: "ip" type: "InnerProduct" bottom: "norm2" top: "ip"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { name: "prob" type: "Softmax" bottom: "ip" top: "prob" }
"""


def test_cuda_classifier_forward_launches_the_lrn_kernel_per_norm(tmp_path):
    """``Classifier.predict`` on the card: one forward of the 10-crop
    batch, the inference LRN kernel once a norm, the probabilities within
    1e-5 of the CPU's on the same weights (TF32 off)."""
    _need_cuda()
    from sparknet_tpu_torch.classify import Classifier
    from sparknet_tpu_torch.graph.net import Net
    from sparknet_tpu_torch.proto import (NetState, Phase, load_net_prototxt,
                                          save_caffemodel)
    (tmp_path / "deploy.prototxt").write_text(CLASSIFY_NET)
    net = Net(load_net_prototxt(CLASSIFY_NET), NetState(Phase.TEST))
    save_caffemodel(str(tmp_path / "w.caffemodel"),
                    net.init(torch.Generator().manual_seed(1), device="cpu"))
    imgs = [np.random.default_rng(i).uniform(size=(20, 24, 3))
            .astype(np.float32) for i in range(3)]
    out = {}
    for dev in ("cuda", "cpu"):
        clf = Classifier(str(tmp_path / "deploy.prototxt"),
                         str(tmp_path / "w.caffemodel"), image_dims=(18, 18),
                         raw_scale=255.0, device=dev)
        ck.reset_launch_counts()
        out[dev] = clf.predict(imgs)
        assert ck.launch_counts["lrn_across_channels"] == (
            2 if dev == "cuda" else 0)
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-5, atol=1e-6)
