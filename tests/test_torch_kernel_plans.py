"""The launch plans of the port's LRN forward and MAX-pool backward
kernels, checked on the CPU without a card.

``cuda_kernels.lrn_plan`` and ``cuda_kernels.max_pool_bwd_plan`` choose,
by shape, how the CUDA kernels cut their work; ``pool_band`` is the pool
kernel's band arithmetic (``csrc/maxpool_bwd.cu::band_of``) line for
line.  These tests check, over the zoo's shapes and odd geometries, that
every plane, dx row, window, (n, c, p) element and channel is covered
exactly once, that every window a band needs reads only input rows the
band stages, and that shared memory and grid dimensions stay within the
card's limits.  A numpy model of the pool kernel's three steps (stage,
argmax, gather), run block by block on a plan, must give the plain
version's dx exactly, on tied inputs.  The kernels themselves run only on
the card (tests/test_torch_cuda_kernels.py, ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import re

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.ops import cuda_kernels as ck
from sparknet_tpu_torch.ops.vision import pool_output_size

# (label, (n, c, h, w), kernel, stride, pad)
POOL_SHAPES = [
    *((f"caffenet_{name}_b{b}", (b, c, hw, hw), 3, 2, 0)
      for name, c, hw in (("pool1", 96, 55), ("pool2", 256, 27),
                          ("pool5", 256, 13))
      for b in (1, 4, 16, 64)),
    ("googlenet_k3s1p1_112", (8, 64, 112, 112), 3, 1, 1),
    ("googlenet_k3s2_112", (8, 64, 112, 112), 3, 2, 0),
    ("googlenet_k3s1p1_28", (16, 192, 28, 28), 3, 1, 1),
    ("vgg_pool1_224", (2, 64, 224, 224), 2, 2, 0),
    ("vgg_pool2_112", (2, 128, 112, 112), 2, 2, 0),
    ("k3s2p1_224", (2, 8, 224, 224), 3, 2, 1),
    ("padded_13_k3s2p1", (2, 4, 13, 13), 3, 2, 1),
    ("overlap_7_k5s3p2", (2, 4, 7, 7), 5, 3, 2),
    ("clipped_17_k2s3p1", (2, 4, 17, 17), 2, 3, 1),
    ("pool5_planes_not_multiple", (64, 251, 13, 13), 3, 2, 0),
    ("wide_row_k3s1p1", (1, 2, 9, 5000), 3, 1, 1),
]

# (label, (n, c, hw)) at every batch the serving engine launches
LRN_SHAPES = [
    *((f"caffenet_{name}_b{b}", (b, c, hw))
      for name, c, hw in (("norm1", 96, 27 * 27), ("norm2", 256, 13 * 13))
      for b in (1, 2, 4, 8, 16, 32, 64)),
    ("googlenet_norm2_b16", (16, 192, 56 * 56)),
    ("odd", (3, 7, 45)),
    ("one_channel", (5, 1, 9)),
    ("batch_over_65535", (70_000, 3, 1)),
    ("batch_over_65535_plane", (70_000, 96, 4)),
]


def _geometry(shape, k, s, p):
    oh, ow = pool_output_size(shape[2], shape[3], k, k, s, s, p, p)
    return (k, k, s, s, p, p, oh, ow)


def _plan(shape, geom, elem):
    n, c, h, w = shape
    return ck.max_pool_bwd_plan(n * c, h, w, *geom, elem)


def _bands(plan, h, geom):
    kh, _, sh, _, ph, _, oh, _ = geom
    return [ck.pool_band(b, plan.bands, plan.band_rows, h, kh, sh, ph, oh)
            for b in range(plan.bands)]


@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", POOL_SHAPES, ids=lambda c: c[0])
def test_pool_plan_covers_planes_rows_and_windows_once(case, elem):
    label, shape, k, s, p = case
    n, c, h, w = shape
    geom = _geometry(shape, k, s, p)
    kh, _, sh, _, ph, _, oh, ow = geom
    plan = _plan(shape, geom, elem)
    planes = n * c
    ppb = plan.planes_per_block
    assert plan.bands == -(-h // plan.band_rows)
    assert ppb == 1 or plan.bands == 1
    # every plane in exactly one block's group
    groups = -(-planes // ppb)
    assert plan.blocks == groups * plan.bands
    owner = np.zeros(planes, np.int64)
    for g in range(groups):
        owner[g * ppb:min(g * ppb + ppb, planes)] += 1
    assert (owner == 1).all()
    bands = _bands(plan, h, geom)
    # every dx row owned by exactly one band, bands in order
    rows = np.zeros(h, np.int64)
    for b in bands:
        rows[b.r0:b.r1] += 1
    assert (rows == 1).all()
    # every (window row, row it covers) pair: that row's owner computes the
    # window, and reads only rows it stages
    for oi in range(oh):
        lo, hi = max(oi * sh - ph, 0), min(oi * sh - ph + kh, h)
        assert lo < hi, "a window with no input row"
        for r in range(lo, hi):
            (b,) = [b for b in bands if b.r0 <= r < b.r1]
            assert b.oi0 <= oi < b.oi0 + b.nwr
    for b in bands:
        for oi in range(b.oi0, b.oi0 + b.nwr):
            assert b.xr0 <= max(oi * sh - ph, 0)
            assert min(oi * sh - ph + kh, h) <= b.xr0 + b.nxr <= h
    if plan.bands == 1:     # whole planes: one contiguous range per group
        assert (bands[0].xr0, bands[0].nxr, bands[0].oi0, bands[0].nwr) \
            == (0, h, 0, oh)
    # limits: shared memory, grid, the kernel's exact small division
    assert plan.smem_bytes == max(ck.pool_band_bytes(b, ppb, w, ow, elem)
                                  for b in bands)
    assert plan.smem_bytes <= ck.SMEM_MAX
    assert plan.blocks <= ck.GRID_X_MAX
    for b in bands:
        assert ppb * max(b.nxr * w, b.nwr * ow, (b.r1 - b.r0) * w) < 2**22
    # whole rows of lanes, at most 256 threads
    lanes = min(w, 256)
    assert plan.threads % lanes == 0 and lanes <= plan.threads <= 256
    # only a plane whose one-row band overflows 48 KB opts in to more
    assert plan.smem_bytes <= ck.SMEM_DEFAULT or label == "wide_row_k3s1p1"


def test_pool_plan_bands_the_planes_too_big_for_one_block():
    """VGG's pool1 and a 224x224 3x3 stride-2 pad-1 pool band in f32 and
    bf16; CaffeNet's pools do not, and pool5's planes are packed, with a
    partial last group at 64 x 251 planes."""
    for shape, k, s, p in (((2, 64, 224, 224), 2, 2, 0),
                           ((2, 8, 224, 224), 3, 2, 1)):
        for elem in (4, 2):
            assert _plan(shape, _geometry(shape, k, s, p), elem).bands > 1
    for hw in (55, 27, 13):
        shape = (64, 96, hw, hw)
        assert _plan(shape, _geometry(shape, 3, 2, 0), 4).bands == 1
    shape = (64, 251, 13, 13)
    plan = _plan(shape, _geometry(shape, 3, 2, 0), 4)
    assert plan.planes_per_block > 1
    assert (64 * 251) % plan.planes_per_block != 0


def test_pool_plan_refuses_a_row_no_block_can_hold():
    with pytest.raises(ValueError, match="shared bytes"):
        ck.max_pool_bwd_plan(1, 8, 40_000, 3, 3, 1, 1, 1, 1, 8, 40_000, 4)


@pytest.mark.parametrize("case", LRN_SHAPES, ids=lambda c: c[0])
def test_lrn_plan_covers_every_element_and_channel_once(case):
    _, (n, c, hw) = case
    plan = ck.lrn_plan(n, c, hw)
    positions = n * hw
    assert plan.chunk in ck.LRN_CHUNKS
    gx, gy = plan.blocks
    assert gx <= ck.GRID_X_MAX and gy <= ck.GRID_Y_MAX
    # position blocks cover (n, p) with no block wholly past the end
    assert (gx - 1) * plan.threads < positions <= gx * plan.threads
    assert (gy - 1) * plan.chunk < c <= gy * plan.chunk
    # the kernel's q -> (n, p) map hits each (n, p) once, and chunks of
    # channels partition [0, c)
    q = np.arange(positions)
    nn, pp = q // hw, q - (q // hw) * hw
    assert np.array_equal(nn * hw + pp, q) and (pp < hw).all()
    chans = np.zeros(c, np.int64)
    for cy in range(gy):
        chans[cy * plan.chunk:min(cy * plan.chunk + plan.chunk, c)] += 1
    assert (chans == 1).all()
    # no longer chunk than the channels need
    assert plan.chunk == ck.LRN_CHUNKS[0] or plan.chunk // 2 < c


def test_lrn_plan_short_chunks_at_small_batches_long_at_large():
    for c, hw in ((96, 27 * 27), (256, 13 * 13)):
        assert ck.lrn_plan(1, c, hw).chunk == ck.LRN_CHUNKS[0]
        assert ck.lrn_plan(64, c, hw).chunk > ck.LRN_CHUNKS[0]
        # every batch gets at least as many threads as a full wave, or the
        # shortest chunk
        for n in (1, 4, 16, 64):
            plan = ck.lrn_plan(n, c, hw)
            threads = n * hw * plan.blocks[1]
            assert (threads >= ck.LRN_FILL_THREADS
                    or plan.chunk == ck.LRN_CHUNKS[0])


def test_lrn_plan_refuses_positions_past_int32():
    with pytest.raises(ValueError, match="positions"):
        ck.lrn_plan(2**16, 3, 2**15)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}


@pytest.mark.parametrize("lib", sorted(ck.SOURCES))
def test_ctypes_signatures_match_the_c_entry_points(lib):
    """Each ``extern "C"`` entry point's parameters, read from its source,
    are what ``_SIGNATURES`` declares to ctypes: a pointer declared as an
    int would be cut to 32 bits at the call."""
    src = (ck._CSRC / ck.SOURCES[lib]).read_text()
    found = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        found[name] = [_C_TYPES[re.sub(r"\s*\w+$", "", p.strip())]
                       for p in params.split(",")]
    assert found == ck._SIGNATURES[lib]


def _row_walk(threads, cols, rows_per_plane, nrows):
    """The (row, col) cells each thread of a pool block visits, as the
    kernel's ``RowWalk`` steps: rows advance by ``step`` with the (plane,
    row in plane) pair carried without a division."""
    lanes = min(cols, threads)
    step = threads // lanes
    seen = []
    for t in range(step * lanes):
        i, rr = divmod(t // lanes, rows_per_plane)
        row = t // lanes
        while row < nrows:
            assert row == i * rows_per_plane + rr
            seen += [(row, col) for col in range(t % lanes, cols, lanes)]
            row += step
            rr += step
            while rr >= rows_per_plane:
                rr -= rows_per_plane
                i += 1
    return seen


@pytest.mark.parametrize("case", POOL_SHAPES, ids=lambda c: c[0])
def test_pool_block_walks_every_window_and_dx_element_once(case):
    """A block's threads visit each window of its band (argmax step) and
    each dx element it owns (gather step) exactly once."""
    _, shape, k, s, p = case
    n, c, h, w = shape
    geom = _geometry(shape, k, s, p)
    ow = geom[7]
    plan = _plan(shape, geom, 4)
    np_ = min(plan.planes_per_block, n * c)
    for b in _bands(plan, h, geom)[:2]:
        for cols, rpp in ((ow, max(b.nwr, 1)), (w, b.r1 - b.r0)):
            nrows = np_ * (b.nwr if cols == ow else b.r1 - b.r0)
            seen = _row_walk(plan.threads, cols, rpp, nrows)
            assert len(seen) == len(set(seen)) == nrows * cols


# ---------------------------------------------------------------------------
# A numpy model of the pool kernel, block by block, on a plan
# ---------------------------------------------------------------------------

SPECIALIZED = {(3, 2), (3, 1), (2, 2)}   # (kernel, stride) compiled fixed


def _model_pool_bwd(x, dy, geom, plan):
    """What ``maxpool_bwd_kernel`` computes, one block at a time: stage
    the band's rows, take each window's first maximum from the staged
    rows only, then gather each owned dx element in row-major window
    order, by cells of stride x stride elements for the geometries the
    kernel compiles fixed, else element by element."""
    kh, kw, sh, sw, ph, pw, oh, ow = geom
    n, c, h, w = x.shape
    xp, dyp = x.reshape(n * c, h, w), dy.reshape(n * c, oh, ow)
    dx = np.full_like(xp, np.nan)
    ppi = plan.planes_per_block
    for block in range(plan.blocks):
        group, band = divmod(block, plan.bands)
        b = ck.pool_band(band, plan.bands, plan.band_rows, h, kh, sh, ph, oh)
        for plane in range(group * ppi, min(group * ppi + ppi, n * c)):
            xs = xp[plane, b.xr0:b.xr0 + b.nxr]          # staged rows
            am = {}
            for oi in range(b.oi0, b.oi0 + b.nwr):
                for oj in range(ow):
                    hs, ws = oi * sh - ph, oj * sw - pw
                    taps = [(hh, ww)
                            for hh in range(max(hs, 0), min(hs + kh, h))
                            for ww in range(max(ws, 0), min(ws + kw, w))]
                    vals = [xs[hh - b.xr0, ww] for hh, ww in taps]
                    am[oi, oj] = (taps[int(np.argmax(vals))],
                                  dyp[plane, oi, oj])
            if kh == kw and sh == sw and (kh, sh) in SPECIALIZED:
                _model_cells(dx[plane], am, b, kh, sh, ph, pw, w, ow)
                continue
            for ih in range(b.r0, b.r1):
                for iw in range(w):
                    acc = np.float32(0)
                    for (oi, oj), (tap, g) in am.items():
                        if tap == (ih, iw):
                            acc = np.float32(acc + g)
                    dx[plane, ih, iw] = acc
    return dx.reshape(x.shape)


def _model_cells(dxp, am, b, k, s, ph, pw, w, ow):
    """The kernel's cell gather: cell (ci, cj) loads windows (ci - d,
    cj - e) once, and element (t, u) of the cell takes those with
    d*s + t < k and e*s + u < k, oi then oj ascending."""
    cover = -(-k // s)
    for ci in range((b.r0 + ph) // s, (b.r1 - 1 + ph) // s + 1):
        for cj in range((w - 1 + pw) // s + 1):
            for t in range(s):
                r = ci * s - ph + t
                if not b.r0 <= r < b.r1:
                    continue
                for u in range(s):
                    col = cj * s - pw + u
                    if not 0 <= col < w:
                        continue
                    acc = np.float32(0)
                    for d in range(cover - 1, -1, -1):
                        for e in range(cover - 1, -1, -1):
                            tap, g = am.get((ci - d, cj - e), (None, 0))
                            if (d * s + t < k and e * s + u < k
                                    and tap == (r, col)):
                                acc = np.float32(acc + g)
                    dxp[r, col] = acc


@pytest.mark.parametrize("band_rows", [1, 2, 3, 5, None])
@pytest.mark.parametrize("geom_case", [((2, 3, 13, 11), 3, 2, 1),
                                       ((2, 3, 13, 11), 3, 2, 0),
                                       ((1, 2, 9, 9), 3, 1, 1),
                                       ((1, 2, 9, 8), 2, 2, 0),
                                       ((2, 2, 7, 7), 5, 3, 2),
                                       ((1, 3, 17, 10), 2, 3, 1)],
                         ids=["k3s2p1", "k3s2", "k3s1p1", "k2s2", "k5s3p2",
                              "k2s3p1"])
def test_pool_kernel_model_on_bands_matches_plain(geom_case, band_rows):
    """Bands of 1, 2, 3, 5 rows (None: whole planes, two per block) on
    tied inputs give exactly the plain version's dx."""
    shape, k, s, p = geom_case
    geom = _geometry(shape, k, s, p)
    n, c, h, w = shape
    if band_rows is None:
        plan = ck.PoolPlan(2, h, 1, -(-(n * c) // 2), ck.POOL_THREADS, 0)
    else:
        bands = -(-h // band_rows)
        plan = ck.PoolPlan(1, band_rows, bands, n * c * bands,
                           ck.POOL_THREADS, 0)
    rng = np.random.default_rng(3)
    x = np.round(2 * np.maximum(rng.normal(size=shape), 0)).astype(
        np.float32)
    dy = rng.normal(size=(n, c, geom[6], geom[7])).astype(np.float32)
    got = _model_pool_bwd(x, dy, geom, plan)
    want = ck.max_pool_bwd_reference(torch.from_numpy(x),
                                     torch.from_numpy(dy), *geom).numpy()
    np.testing.assert_array_equal(got, want)
