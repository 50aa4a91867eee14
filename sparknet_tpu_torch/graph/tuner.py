"""Lowering autotuner: measured per-(op, shape, dtype, backend) selection
behind one seam.

The port's own copy of ``sparknet_tpu/graph/tuner.py``: the same keys,
table schema and rules, filled with the port's lowerings.

- A **candidate registry** per op family (``lrn``, ``conv``, ``pool``,
  ``lrn_epilogue``).  Each candidate declares its numerics contract up
  front (``exact``: forward bit-parity with the key's default, or a
  relative bound) and the backend it requires.
- A **measurement harness** (:func:`measure_key`): warm-up discarded,
  the median of k forward+backward runs, the candidates' runs
  interleaved, and a numerics verdict that disqualifies a candidate
  before it can win.  On the card each run is timed alone with CUDA
  events after the L2 cache was flushed (as ``chip_smoke.py``'s
  ``time_ms``); on the CPU with the host clock over a calibrated loop.
  A candidate that raises records a typed ``skipped`` entry.
- A **schema-versioned tuning table**,
  ``sparknet_tpu_torch/profiles/<backend>/tuning.json``: newer, drifted,
  unparseable and wrong-backend tables are refused loudly.  The port
  never reads the root ``profiles/``, whose tables hold XLA lowerings.
- One knob, ``SPARKNET_TUNE=off|auto|<table path>`` (default ``auto``:
  the committed table for the backend, the built-in defaults on a miss),
  latched by ``Net`` at construction, which hands each conv, MAX-pool,
  LRN and epilogue node the table's choice for it
  (:meth:`TuningTable.overrides`); a layer called on its own reads it
  through :func:`resolve_lowering`.

Bit-parity rule: a candidate may win only if its forward equals the
default's bit for bit and its gradients stay within its declared bound,
unless ``allow_inexact``.  On ``cuda`` a candidate that would take a
hand-written kernel off the path (``off_kernel``: the plain LRN, the
cumsum LRN, the patches MAX pool, the plain epilogue) is timed and kept
for the record, ``ineligible``, and never wins, not even with
``allow_inexact``; a ``cuda`` table naming one is refused at load, and a
seam handed one on a CUDA tensor raises.

Lowerings (candidates, default on ``cuda`` / ``cpu``):

- ``lrn``: ``cuda`` (``ops/vision.py::relu_lrn``: B1/B3 under autograd,
  B2 without), ``plain`` (autograd through the plain window sum),
  ``cumsum`` (channel prefix sums); ``cuda`` / ``plain``.
- ``conv``: ``native`` (``F.conv2d``, cuDNN), ``s2d`` (space-to-depth,
  where the JAX geometry admits it), ``im2col`` (``unfold`` +
  ``torch.matmul``); ``native`` on both.
- ``pool`` (MAX): ``cuda_bwd`` (``MaxPool``: the first-maximum kernel as
  its backward on a CUDA tensor, its plain version on a CPU tensor),
  ``patches_max``; ``cuda_bwd`` on both.
- ``lrn_epilogue``: ``cuda`` (the ReLU folded into B1/B2/B3),
  ``per_layer`` (the ReLU, then the LRN kernels with ``relu=0``),
  ``plain``; ``cuda`` / ``plain``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import knobs

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TABLE_VERSION = 1
TABLE_FILENAME = "tuning.json"
L2_FLUSH_BYTES = 128 * 2**20     # > the H100's 50 MB L2

# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

_DTYPE_CANON = {
    "float32": "f32", "bfloat16": "bf16", "float16": "f16",
    "float64": "f64", "f32": "f32", "bf16": "bf16", "f16": "f16",
    "f64": "f64",
}
_TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "f16": torch.float16, "f64": torch.float64}


def dtype_str(dtype: torch.dtype | str) -> str:
    """Canonical short dtype tag for a key ("f32", "bf16", ...) of a
    torch dtype or a name."""
    name = (str(dtype).replace("torch.", "")
            if isinstance(dtype, torch.dtype) else dtype)
    return _DTYPE_CANON.get(name, name)


def torch_dtype(tag: str) -> torch.dtype:
    return _TORCH_DTYPES[tag]


@dataclasses.dataclass(frozen=True)
class TuneKey:
    """One tuning-table key: (op, shape, dtype) plus the op-specific
    ``extra`` geometry tag that makes lowerings comparable."""
    op: str
    shape: tuple
    dtype: str
    extra: str = ""

    def __str__(self) -> str:
        return key_str(self.op, self.shape, self.dtype, self.extra)


def key_str(op: str, shape, dtype, extra: str = "") -> str:
    dims = "x".join(str(int(d)) for d in shape)
    base = f"{op}/{dims}/{dtype_str(dtype)}"
    return f"{base}/{extra}" if extra else base


def parse_key(ks: str) -> TuneKey:
    parts = ks.split("/")
    if len(parts) < 3:
        raise ValueError(f"malformed tuning key {ks!r}")
    op, dims, dt = parts[0], parts[1], parts[2]
    shape = tuple(int(d) for d in dims.split("x"))
    return TuneKey(op, shape, dt, "/".join(parts[3:]))


def conv_extra(kh, kw, sh, sw, ph, pw, dh, dw, num_output, group) -> str:
    return (f"k{kh}x{kw}s{sh}x{sw}p{ph}x{pw}d{dh}x{dw}"
            f"o{num_output}g{group}")


def pool_extra(kh, kw, sh, sw, ph, pw) -> str:
    return f"max:k{kh}x{kw}s{sh}x{sw}p{ph}x{pw}"


def lrn_extra(size: int) -> str:
    return f"s{size}"


def epilogue_extra(size: int, relu: bool) -> str:
    return f"s{size}:relu{int(bool(relu))}"


_CONV_EXTRA_RE = re.compile(
    r"k(\d+)x(\d+)s(\d+)x(\d+)p(\d+)x(\d+)d(\d+)x(\d+)o(\d+)g(\d+)$")
_POOL_EXTRA_RE = re.compile(r"max:k(\d+)x(\d+)s(\d+)x(\d+)p(\d+)x(\d+)$")
_LRN_EXTRA_RE = re.compile(r"s(\d+)$")
_EPI_EXTRA_RE = re.compile(r"s(\d+):relu([01])$")


# ---------------------------------------------------------------------------
# candidate registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Candidate:
    """One registered lowering for an op family.

    ``exact`` declares forward bit-parity with the key's default
    lowering; otherwise ``rtol`` is the declared forward bound.
    ``grad_rtol`` is the declared gradient bound.  ``requires`` names a
    backend the candidate only runs on (elsewhere a typed skip).
    ``off_kernel`` marks a lowering that takes a hand-written kernel off
    the path: on ``cuda`` it is timed for the record and never wins."""
    name: str
    exact: bool = True
    rtol: float = 1e-5
    grad_rtol: float = 1e-5
    requires: str | None = None
    off_kernel: bool = False
    note: str = ""


@dataclasses.dataclass
class Problem:
    """A concrete measurement instance for one key: deterministic inputs
    plus one callable per available candidate; candidates proven
    unavailable up front (geometry, backend) carry a typed reason in
    ``unavailable`` instead."""
    inputs: tuple
    fns: dict[str, Callable]
    unavailable: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class OpSpec:
    op: str
    candidates: tuple[Candidate, ...]
    build: Callable[[TuneKey, torch.device], Problem]
    default: Callable[[TuneKey, str], str]


def _backend() -> str:
    """The backend whose table ``auto`` reads: ``cuda`` where the card
    is, else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _rand(shape, dtype_tag: str, device, seed: int = 0,
          scale: float = 1.0) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32) * scale
    return torch.from_numpy(x).to(device=device,
                                  dtype=torch_dtype(dtype_tag))


# -- lrn --------------------------------------------------------------------

_LRN_ALPHA, _LRN_BETA, _LRN_K = 1e-4, 0.75, 1.0


def _build_lrn(key: TuneKey, device: torch.device) -> Problem:
    from ..ops import cuda_kernels as ck
    from ..ops import vision
    m = _LRN_EXTRA_RE.match(key.extra)
    if not m:
        raise ValueError(f"lrn key needs extra 's<size>', got {key.extra!r}")
    size = int(m.group(1))
    args = (size, _LRN_ALPHA, _LRN_BETA, _LRN_K)
    fns = {
        "plain": lambda xx: ck.lrn_across_channels_reference(xx, *args),
        "cumsum": lambda xx: vision.lrn_cumsum(xx, *args),
    }
    if device.type == "cuda":
        fns["cuda"] = lambda xx: vision.relu_lrn(xx, *args)
    return Problem(inputs=(_rand(key.shape, key.dtype, device),), fns=fns)


def _default_lrn(key: TuneKey, backend: str) -> str:
    return "cuda" if backend == "cuda" else "plain"


_LRN_CANDIDATES = (
    Candidate("cuda", exact=False, rtol=1e-4, grad_rtol=1e-4,
              requires="cuda",
              note="hand kernels: B1/B3 under autograd, B2 without"),
    Candidate("plain", exact=False, rtol=1e-4, grad_rtol=1e-4,
              off_kernel=True,
              note="the plain window sum by shifted adds; autograd "
                   "backward"),
    Candidate("cumsum", exact=False, rtol=1e-4, grad_rtol=1e-4,
              off_kernel=True,
              note="channel prefix-sum difference — exact up to float "
                   "association"),
)


# -- conv -------------------------------------------------------------------

def _build_conv(key: TuneKey, device: torch.device) -> Problem:
    from ..ops import vision
    m = _CONV_EXTRA_RE.match(key.extra)
    if not m:
        raise ValueError(f"conv key needs geometry extra, got {key.extra!r}")
    kh, kw, sh, sw, ph, pw, dh, dw, o, g = (int(v) for v in m.groups())
    n, c, h, w = key.shape
    x = _rand(key.shape, key.dtype, device)
    wgt = _rand((o, c // g, kh, kw), key.dtype, device, seed=1, scale=0.05)
    fns = {
        "native": lambda xx, ww: F.conv2d(
            xx, ww, None, stride=(sh, sw), padding=(ph, pw),
            dilation=(dh, dw), groups=g),
        "im2col": lambda xx, ww: vision.im2col_conv(
            xx, ww, kh, kw, sh, sw, ph, pw, dh, dw, g),
    }
    unavailable = {}
    if vision.s2d_geometry_ok(c, kh, kw, sh, sw, ph, pw, dh, dw, g):
        fns["s2d"] = lambda xx, ww: vision.space_to_depth_conv(
            xx, ww, kh, kw, sh, sw, ph, pw)
    else:
        unavailable["s2d"] = ("geometry ineligible (needs group==1, "
                              "dilation 1, strided, c_in*s*s<=64, k>=s)")
    return Problem(inputs=(x, wgt), fns=fns, unavailable=unavailable)


def _default_conv(key: TuneKey, backend: str) -> str:
    return "native"


_CONV_CANDIDATES = (
    # native/s2d/im2col are cross-inexact (summation order): exactness is
    # measured against this key's default
    Candidate("native", exact=False, rtol=1e-5,
              note="F.conv2d (cuDNN on the card)"),
    Candidate("s2d", exact=False, rtol=1e-5,
              note="space-to-depth stride-phase regroup; exact up to "
                   "summation order"),
    Candidate("im2col", exact=False, rtol=1e-5,
              note="F.unfold + a grouped torch.matmul (Caffe's lowering)"),
)


# -- pool (MAX) -------------------------------------------------------------

def _build_pool(key: TuneKey, device: torch.device) -> Problem:
    from ..ops import vision
    m = _POOL_EXTRA_RE.match(key.extra)
    if not m:
        raise ValueError(f"pool key needs extra 'max:k..s..p..', "
                         f"got {key.extra!r}")
    kh, kw, sh, sw, ph, pw = (int(v) for v in m.groups())
    n, c, h, w = key.shape
    oh, ow = vision.pool_output_size(h, w, kh, kw, sh, sw, ph, pw)
    fns = {
        "cuda_bwd": lambda xx: vision.max_pool_layer(
            xx, kh, kw, sh, sw, ph, pw, oh, ow),
    }
    unavailable = {}
    if vision.patches_pool_ok(h, w, kh, kw, sh, sw, ph, pw):
        fns["patches_max"] = lambda xx: vision.max_pool_patches(
            xx, kh, kw, sh, sw, oh, ow)
    else:
        unavailable["patches_max"] = (
            "padding/remainder ineligible (patches pad with 0, not -inf; "
            "needs p==0 and (dim-k) % s == 0)")
    return Problem(inputs=(_rand(key.shape, key.dtype, device),), fns=fns,
                   unavailable=unavailable)


def _default_pool(key: TuneKey, backend: str) -> str:
    return "cuda_bwd"


_POOL_CANDIDATES = (
    Candidate("cuda_bwd", grad_rtol=1e-4,
              note="max pool over -inf padding; the first-maximum kernel "
                   "as backward on a CUDA tensor, its plain version on a "
                   "CPU tensor"),
    Candidate("patches_max", grad_rtol=1e-4, off_kernel=True,
              note="unfold + argmax/gather; max is association-free so "
                   "the forward is bit-exact, and the gather routes the "
                   "gradient to the first maximum"),
)


# -- lrn_epilogue (fused-chain tail from graph/fusion.py) -------------------

def _build_epilogue(key: TuneKey, device: torch.device) -> Problem:
    from ..ops import cuda_kernels as ck
    from ..ops import vision
    m = _EPI_EXTRA_RE.match(key.extra)
    if not m:
        raise ValueError(f"lrn_epilogue key needs extra 's<size>:relu<0|1>', "
                         f"got {key.extra!r}")
    size, relu = int(m.group(1)), bool(int(m.group(2)))
    args = (size, _LRN_ALPHA, _LRN_BETA, _LRN_K)
    fns = {
        "per_layer": lambda xx: vision.relu_lrn(
            torch.relu(xx) if relu else xx, *args),
        "plain": lambda xx: ck.lrn_across_channels_reference(xx, *args,
                                                             relu),
    }
    if device.type == "cuda":
        fns["cuda"] = lambda xx: vision.relu_lrn(xx, *args, relu=relu)
    return Problem(inputs=(_rand(key.shape, key.dtype, device),), fns=fns)


def _default_epilogue(key: TuneKey, backend: str) -> str:
    return "cuda" if backend == "cuda" else "plain"


_EPILOGUE_CANDIDATES = (
    Candidate("cuda", exact=False, rtol=1e-4, grad_rtol=1e-4,
              requires="cuda",
              note="the ReLU folded into the hand LRN kernels"),
    Candidate("per_layer", exact=False, rtol=1e-4, grad_rtol=1e-4,
              note="the ReLU, then the LRN kernels with relu=0 (what the "
                   "unfused per-layer path runs)"),
    Candidate("plain", exact=False, rtol=1e-4, grad_rtol=1e-4,
              off_kernel=True,
              note="the plain [ReLU+]LRN; autograd backward"),
)


_REGISTRY: dict[str, OpSpec] = {
    "lrn": OpSpec("lrn", _LRN_CANDIDATES, _build_lrn, _default_lrn),
    "conv": OpSpec("conv", _CONV_CANDIDATES, _build_conv, _default_conv),
    "pool": OpSpec("pool", _POOL_CANDIDATES, _build_pool, _default_pool),
    "lrn_epilogue": OpSpec("lrn_epilogue", _EPILOGUE_CANDIDATES,
                           _build_epilogue, _default_epilogue),
}

# test-registered extra candidates: op -> [(Candidate, factory)], factory
# called as factory(key, problem) -> callable
_EXTRA: dict[str, list] = {}


def ops() -> list[str]:
    return sorted(_REGISTRY)


def candidates_for(op: str) -> list[Candidate]:
    spec = _REGISTRY.get(op)
    if spec is None:
        raise ValueError(f"unknown tunable op {op!r} (have {ops()})")
    return list(spec.candidates) + [c for c, _ in _EXTRA.get(op, [])]


# what measure_key, the table loader and the seams say of an off_kernel
# candidate on cuda
OFF_KERNEL_RULE = ("takes a hand-written kernel off the path on cuda: an "
                   "off_kernel candidate never wins there")


def refuse_off_kernel(op: str, name: str, where: str) -> None:
    """Raise ValueError naming the rule when ``name`` is an ``off_kernel``
    candidate of ``op``: such a lowering may be timed on the card for the
    record but never run there (``where`` says who asked)."""
    if op in _REGISTRY and any(c.off_kernel and c.name == name
                               for c in candidates_for(op)):
        raise ValueError(f"{where}: {op} lowering {name!r} "
                         f"{OFF_KERNEL_RULE}")


def register_candidate(op: str, cand: Candidate, factory) -> None:
    """Register an extra candidate for ``op`` (tests plant slow or wrong
    candidates through this; a production candidate belongs in the
    static registry above)."""
    if op not in _REGISTRY:
        raise ValueError(f"unknown tunable op {op!r} (have {ops()})")
    _EXTRA.setdefault(op, []).append((cand, factory))


def clear_extra_candidates(op: str | None = None) -> None:
    if op is None:
        _EXTRA.clear()
    else:
        _EXTRA.pop(op, None)


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _timing_params(reps, target_s, warmup):
    if reps is None:
        reps = knobs.get_int("SPARKNET_TUNE_REPS", 5)
    if target_s is None:
        target_s = knobs.get_float("SPARKNET_TUNE_TARGET_S", 0.1)
    if warmup is None:
        warmup = knobs.get_int("SPARKNET_TUNE_WARMUP", 2)
    return max(3, int(reps)), float(target_s), max(1, int(warmup))


def _typed_skip(e: BaseException) -> str:
    msg = str(e).strip().split("\n")[0][:200]
    return f"{type(e).__name__}: {msg}" if msg else type(e).__name__


def _forward(fn, inputs) -> torch.Tensor:
    with torch.no_grad():
        return fn(*inputs)


def _fwdbwd(fn, inputs) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """(mean of the output in f32, the gradients of it with respect to
    every input)."""
    ins = [t.detach().requires_grad_(True) for t in inputs]
    loss = fn(*ins).float().mean()
    return loss, torch.autograd.grad(loss, ins)


def _time_interleaved(calls: dict[str, Callable], reps: int,
                      target_s: float, warmup: int,
                      device: torch.device) -> dict[str, tuple | str]:
    """Median ms and relative spread of one call of each candidate, their
    runs interleaved: run r of every candidate comes before run r + 1 of
    any, so a burst of other load on the host lands on all of them alike
    instead of moving one candidate's median.  On the card a run is one
    call timed alone with CUDA events after a write that evicts the L2
    cache, a ~1 ms spin on the card ahead of the start event hiding the
    host's enqueue; on the CPU a loop calibrated to about ``target_s``.
    A candidate that raises gets its typed reason instead."""
    cuda = device.type == "cuda"
    pc = time.perf_counter
    live, out, iters = dict(calls), {}, {}
    for name, call in list(live.items()):
        try:
            for _ in range(warmup):
                call()
            t0 = pc()
            call()
            iters[name] = max(1, min(1024, int(round(
                target_s / max(pc() - t0, 1e-7)))))
        except Exception as e:  # noqa: BLE001 — typed skip, not abort
            out[name] = _typed_skip(e)
            del live[name]
    flush = (torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                         device=device) if cuda else None)
    if cuda:
        torch.cuda.synchronize(device)
    runs: dict[str, list] = {name: [] for name in live}
    for _ in range(reps):
        for name, call in list(live.items()):
            try:
                if cuda:
                    flush.zero_()
                    torch.cuda._sleep(2_000_000)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    call()
                    end.record()
                    runs[name].append((start, end))
                else:
                    t0 = pc()
                    for _ in range(iters[name]):
                        call()
                    runs[name].append((pc() - t0) / iters[name] * 1e3)
            except Exception as e:  # noqa: BLE001 — typed skip
                out[name] = _typed_skip(e)
                del live[name]
    if cuda:
        torch.cuda.synchronize(device)
    for name in live:
        times = sorted(s.elapsed_time(e) for s, e in runs[name]) if cuda \
            else sorted(runs[name])
        med = times[len(times) // 2]
        out[name] = (med, (times[-1] - times[0]) / max(med, 1e-12))
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().cpu().view(torch.uint8)


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a = a.detach().cpu().double()
    b = b.detach().cpu().double()
    denom = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) / denom


def _numerics_verdict(cand: Candidate, out, grads, ref_out, ref_grads,
                      dtype_tag: str) -> tuple[str | None, bool]:
    """(None if the candidate keeps its declared contract against the
    default lowering, else the reason; whether its forward is bit-
    identical, the winner-eligibility bit)."""
    bit = (tuple(out.shape) == tuple(ref_out.shape)
           and out.dtype == ref_out.dtype
           and torch.equal(_bits(out), _bits(ref_out)))
    eps = float(torch.finfo(torch_dtype(dtype_tag)).eps)
    reason = None
    if cand.exact and not bit:
        reason = (f"declared exact but forward differs from default "
                  f"(max rel err {_max_rel(out, ref_out):.3g})")
    elif not cand.exact and not bit:
        tol = max(cand.rtol, 16.0 * eps)
        err = _max_rel(out, ref_out)
        if not err <= tol:
            reason = f"forward rel err {err:.3g} > declared bound {tol:.3g}"
    if reason is None:
        gtol = max(cand.grad_rtol, 64.0 * eps)
        for i, (g, rg) in enumerate(zip(grads, ref_grads)):
            gerr = _max_rel(g, rg)
            if not gerr <= gtol:
                reason = (f"grad[{i}] rel err {gerr:.3g} > declared "
                          f"bound {gtol:.3g}")
                break
    return reason, bit


def measure_key(key: TuneKey, *, reps=None, target_s=None, warmup=None,
                allow_inexact: bool = False,
                device: str | torch.device = "cuda") -> dict:
    """Measure every registered candidate at ``key`` on ``device`` (the
    card by default; raises without one) and pick a winner.

    - a candidate that raises records a typed ``skipped`` entry and the
      run continues;
    - a candidate failing its declared numerics contract against the
      default lowering is ``disqualified``: timed for the record, never
      a winner;
    - unless ``allow_inexact``, a candidate whose forward is not
      bit-identical to the default is ``ineligible`` (timed and
      persisted, cannot win): this keeps ``SPARKNET_TUNE=auto``
      forward-bit-equal to ``off``;
    - on ``cuda`` an ``off_kernel`` candidate is ``ineligible`` whatever
      ``allow_inexact`` says.
    """
    from ..utils.device import full_f32, resolve_device
    dev = resolve_device(device)
    backend = dev.type
    spec = _REGISTRY.get(key.op)
    if spec is None:
        raise ValueError(f"unknown tunable op {key.op!r} (have {ops()})")
    reps, target_s, warmup = _timing_params(reps, target_s, warmup)
    with full_f32():
        prob = spec.build(key, dev)
        fns = dict(prob.fns)
        unavailable = dict(prob.unavailable)
        cands = list(spec.candidates)
        for cand, factory in _EXTRA.get(key.op, []):
            cands.append(cand)
            try:
                fns[cand.name] = factory(key, prob)
            except Exception as e:  # noqa: BLE001 — typed skip, not abort
                unavailable[cand.name] = _typed_skip(e)

        default = spec.default(key, backend)
        if default not in fns:
            raise RuntimeError(f"default lowering {default!r} unavailable "
                               f"at {key} — registry bug")
        ref_out = _forward(fns[default], prob.inputs)
        ref_grads = _fwdbwd(fns[default], prob.inputs)[1]

        timings: dict[str, dict] = {}
        bits: dict[str, bool] = {}
        for cand in cands:
            name = cand.name
            if cand.requires and cand.requires != backend:
                timings[name] = {"skipped": f"requires {cand.requires} "
                                            f"backend (running {backend})"}
                continue
            if name in unavailable:
                timings[name] = {"skipped": unavailable[name]}
                continue
            if name not in fns:
                timings[name] = {"skipped": "no implementation registered"}
                continue
            try:
                rec: dict[str, Any] = {}
                bit = True
                if name == default:
                    rec["forward_exact"] = True
                else:
                    out = _forward(fns[name], prob.inputs)
                    grads = _fwdbwd(fns[name], prob.inputs)[1]
                    reason, bit = _numerics_verdict(
                        cand, out, grads, ref_out, ref_grads, key.dtype)
                    rec["forward_exact"] = bool(bit)
                    if reason is not None:
                        rec["disqualified"] = reason
                timings[name] = rec
                bits[name] = bit
            except Exception as e:  # noqa: BLE001 — typed skip, not abort
                timings[name] = {"skipped": _typed_skip(e)}
        timed = _time_interleaved(
            {name: (lambda fn=fns[name]: _fwdbwd(fn, prob.inputs))
             for name in bits}, reps, target_s, warmup, dev)

    by_name = {c.name: c for c in cands}
    qualified: dict[str, float] = {}
    for name, t in timed.items():
        if isinstance(t, str):
            timings[name] = {"skipped": t}
            continue
        rec = timings[name]
        ms, spread = t
        rec["ms"] = round(ms, 5)
        rec["rel_spread"] = round(spread, 4)
        if "disqualified" in rec:
            continue
        if backend == "cuda" and by_name[name].off_kernel \
                and name != default:
            rec["ineligible"] = f"{OFF_KERNEL_RULE} (kept for the record)"
        elif bits[name] or allow_inexact or name == default:
            qualified[name] = ms
        else:
            rec["ineligible"] = ("not forward-bit-identical to default "
                                 f"{default!r} (--allow-inexact to permit)")

    if not qualified:
        raise RuntimeError(f"no qualified candidate at {key} "
                           f"(timings: {timings})")
    winner = min(qualified, key=qualified.get)
    rest = sorted(v for k, v in qualified.items() if k != winner)
    margin = ((rest[0] - qualified[winner]) / max(qualified[winner], 1e-12)
              if rest else None)
    noise = max([0.05] + [r.get("rel_spread", 0.0)
                          for r in timings.values() if "ms" in r])
    return {
        "key": str(key),
        "op": key.op,
        "winner": winner,
        "default": default,
        "flip": winner != default,
        "margin": round(margin, 4) if margin is not None else None,
        "noise_band": round(noise, 4),
        "timings": timings,
        "measured_at": time.time(),
    }


# ---------------------------------------------------------------------------
# tuning table (the FusionPlan stale-file discipline)
# ---------------------------------------------------------------------------

class TuningTable:
    """Versioned winners-per-key for one backend, persisted as
    ``sparknet_tpu_torch/profiles/<backend>/tuning.json``.  A table of a
    newer schema, missing required fields, captured for another backend,
    or a ``cuda`` table whose winner takes a hand-written kernel off the
    path, is refused with ValueError: a drifted or hand-edited table must
    never silently change which lowerings run."""

    def __init__(self, backend: str, entries: list[dict],
                 provenance: dict | None = None,
                 version: int = TABLE_VERSION):
        self.backend = backend
        self.entries = list(entries)
        self.provenance = provenance or {}
        self.version = version
        self._by_key = {e["key"]: e for e in self.entries}
        self._overrides: dict[tuple, dict[tuple, str]] | None = None

    def winner(self, key: str) -> str | None:
        e = self._by_key.get(key)
        return e["winner"] if e else None

    def overrides(self, op: str, extra: str) -> dict[tuple, str]:
        """``{(shape, torch dtype): winner}`` of the entries for ``op`` at
        geometry ``extra`` whose winner is not the seam's built-in
        lowering (:data:`BUILTIN`): what a Net hands one node at
        construction.  Empty where the table changes nothing there."""
        if self._overrides is None:
            self._overrides = {}
            for e in self.entries:
                k = parse_key(e["key"])
                if e["winner"] != BUILTIN.get(k.op) and k.dtype in \
                        _TORCH_DTYPES:
                    self._overrides.setdefault((k.op, k.extra), {})[
                        (k.shape, torch_dtype(k.dtype))] = e["winner"]
        return self._overrides.get((op, extra), {})

    def table_id(self) -> str:
        """Short content hash for the perf-ledger ``tune_plan`` field
        (like FusionPlan.plan_id); "off" never appears here — that is
        the no-table sentinel."""
        if not self.entries:
            return "tt0"
        canon = "|".join(sorted(f"{e['key']}={e['winner']}"
                                for e in self.entries))
        h = hashlib.sha1(canon.encode()).hexdigest()[:8]
        return f"tt{len(self.entries)}-{h}"

    def to_doc(self) -> dict:
        return {
            "kind": "tuning_table",
            "version": self.version,
            "backend": self.backend,
            "table_id": self.table_id(),
            "provenance": self.provenance,
            "entries": self.entries,
        }

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_doc(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def from_doc(cls, doc: dict, origin: str = "<doc>") -> "TuningTable":
        if not isinstance(doc, dict) or doc.get("kind") != "tuning_table":
            raise ValueError(
                f"{origin}: not a tuning table (kind="
                f"{doc.get('kind') if isinstance(doc, dict) else type(doc)})")
        ver = doc.get("version")
        if not isinstance(ver, int):
            raise ValueError(f"{origin}: tuning table has no integer "
                             f"schema version — refusing a drifted file")
        if ver > TABLE_VERSION:
            raise ValueError(
                f"{origin}: tuning table schema v{ver} is newer than this "
                f"build understands (v{TABLE_VERSION}) — refusing to guess")
        backend = doc.get("backend")
        entries = doc.get("entries")
        if not isinstance(backend, str) or not isinstance(entries, list):
            raise ValueError(f"{origin}: tuning table missing backend/"
                             f"entries — refusing a drifted file")
        for i, e in enumerate(entries):
            if not (isinstance(e, dict) and isinstance(e.get("key"), str)
                    and isinstance(e.get("winner"), str)
                    and isinstance(e.get("timings"), dict)):
                raise ValueError(
                    f"{origin}: entry {i} missing key/winner/timings — "
                    f"refusing a drifted file")
            if backend == "cuda":
                refuse_off_kernel(parse_key(e["key"]).op, e["winner"],
                                  f"{origin}: entry {e['key']}")
        return cls(backend, entries, doc.get("provenance") or {}, ver)

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        with open(path) as f:
            try:
                doc = json.load(f)
            except ValueError as e:
                raise ValueError(f"{path}: unparseable tuning table "
                                 f"({e}) — refusing") from e
        return cls.from_doc(doc, origin=path)


def build_table(keys, *, reps=None, target_s=None, warmup=None,
                allow_inexact: bool = False, progress=None,
                device: str | torch.device = "cuda",
                provenance: dict | None = None) -> TuningTable:
    """Measure ``keys`` on ``device`` and assemble a TuningTable for its
    backend, stamped with the git sha and perf-ledger provenance (plus
    ``provenance``, e.g. the card's name and power limit)."""
    from ..utils import perfledger
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    entries = []
    for key in keys:
        e = measure_key(key, reps=reps, target_s=target_s, warmup=warmup,
                        allow_inexact=allow_inexact, device=dev)
        e["sha"] = perfledger.git_sha()
        entries.append(e)
        if progress is not None:
            progress(e)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    fp = perfledger.fingerprint(model="tuner", dtype="-", batch=0,
                                device=f"{dev.type}/{kind}")
    return TuningTable(dev.type, entries,
                       provenance={**perfledger.provenance(fp),
                                   **(provenance or {})})


# ---------------------------------------------------------------------------
# resolution: SPARKNET_TUNE, latched per Net
# ---------------------------------------------------------------------------

_TABLE_CACHE: dict[str, tuple[float, TuningTable]] = {}

# the lowering each seam runs when no table names one: a table entry
# naming it changes nothing (on the CPU too, where the CUDA lowerings'
# wrappers run their plain versions)
BUILTIN = {"lrn": "cuda", "conv": "native", "pool": "cuda_bwd",
           "lrn_epilogue": "cuda"}


def default_table_path(backend: str | None = None,
                       pkg: str | None = None) -> str:
    return os.path.join(pkg or _PKG_ROOT, "profiles",
                        backend or _backend(), TABLE_FILENAME)


def _load_cached(path: str) -> TuningTable:
    mtime = os.path.getmtime(path)
    hit = _TABLE_CACHE.get(path)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    table = TuningTable.load(path)
    backend = _backend()
    if table.backend != backend:
        raise ValueError(
            f"{path}: tuning table captured for backend "
            f"{table.backend!r} refused on backend {backend!r} — winners "
            f"do not transfer across backends (re-run tools/tune.py run)")
    _TABLE_CACHE[path] = (mtime, table)
    return table


def active_table() -> TuningTable | None:
    """The tuning table ``SPARKNET_TUNE`` selects, or None (the built-in
    defaults).  ``off``/``0`` -> None; ``auto``/unset -> the port's
    committed ``profiles/<backend>/tuning.json`` if present; anything
    else must be a readable table path — a typo here must not silently
    change which lowerings run, so it raises."""
    env = (knobs.raw("SPARKNET_TUNE") or "auto").strip()
    if env in ("off", "0"):
        return None
    if env in ("auto", "1"):
        path = default_table_path()
        if not os.path.isfile(path):
            return None
        return _load_cached(path)
    if not os.path.isfile(env):
        raise ValueError(
            f"SPARKNET_TUNE={env!r}: not off|auto and no such table file — "
            f"a typo here must not silently change which lowerings run")
    return _load_cached(env)


def active_plan_id() -> str:
    """The perf-ledger ``tune_plan`` value for the current environment
    ("off" when no table is active)."""
    t = active_table()
    return t.table_id() if t is not None else "off"


def resolve_lowering(op: str, shape, dtype, *, extra: str = "") -> str | None:
    """The seam of a layer called on its own: which lowering the table
    ``SPARKNET_TUNE`` selects names for ``op`` at this (shape, dtype), or
    None for "use the built-in default" (a miss, ``off``, or no table).
    A Net resolves its layers once, at construction
    (:meth:`TuningTable.overrides`), and hands each its choice."""
    table = active_table()
    if table is None:
        return None
    return table.winner(key_str(op, shape, dtype, extra))


def _clear_caches() -> None:
    """Test hook: forget loaded tables."""
    _TABLE_CACHE.clear()


# ---------------------------------------------------------------------------
# net walking + staleness
# ---------------------------------------------------------------------------

def seam_of(lp, bottom_shape) -> tuple[str, str] | None:
    """(op, extra) of the tuner seam a layer of this type and geometry
    consults, or None: a Convolution, a MAX Pooling, an ACROSS_CHANNELS
    LRN."""
    from ..ops import vision
    t = lp.type
    if t == "Convolution":
        return "conv", conv_extra(*vision.conv_geometry(lp)[:10])
    if t == "Pooling" and bottom_shape is not None \
            and len(bottom_shape) == 4:
        kh, kw, sh, sw, ph, pw, method = vision._pool_geometry(
            lp, bottom_shape)
        if method == "MAX":
            return "pool", pool_extra(kh, kw, sh, sw, ph, pw)
    elif t == "LRN":
        size, _, _, _, region = vision.lrn_geometry(lp)
        if region == "ACROSS_CHANNELS":
            return "lrn", lrn_extra(size)
    return None


def keys_for_net(net, dtype="f32") -> list[TuneKey]:
    """Every tunable (op, shape, dtype) key a built Net consults: conv,
    pool and lrn layer keys plus the fused chains' epilogue keys from its
    fusion plan.  Order follows the graph; duplicates collapse.

    A ``relu+lrn`` chain is keyed ``lrn_epilogue/.../s<size>:relu1``,
    which is what ``ops.vision.lrn_chain_epilogue`` consults; the JAX
    function tests for an epilogue named ``relu_lrn``, which no plan
    names, and so keys such an LRN as a plain ``lrn`` layer
    (ROADMAP C)."""
    from ..ops import vision
    keys: list[TuneKey] = []
    seen: set[str] = set()

    def add(k: TuneKey):
        s = str(k)
        if s not in seen:
            seen.add(s)
            keys.append(k)

    fused_lrn: set[str] = set()
    plan = getattr(net, "_fuse_plan", None)
    if plan is not None:
        for ch in plan.chains:
            if ch.epilogue in ("lrn", "relu+lrn"):
                lrn_name = ch.members[-1]
                node = net._node_by_name.get(lrn_name)
                if node is None:
                    continue
                fused_lrn.add(lrn_name)
                # the epilogue reads the tail's bottom, or under relu+lrn
                # the ReLU's bottom: the same shape
                shape = net.blob_shapes.get(node.bottoms[0])
                size = vision.lrn_geometry(node.lp)[0]
                if shape is not None and len(shape) == 4:
                    add(TuneKey("lrn_epilogue", tuple(shape), dtype,
                                epilogue_extra(
                                    size, ch.epilogue == "relu+lrn")))
    for node in net.nodes:
        if not node.bottoms or node.lp.name in fused_lrn:
            continue
        shape = net.blob_shapes.get(node.bottoms[0])
        if shape is None or len(shape) != 4:
            continue
        seam = seam_of(node.lp, shape)
        if seam is not None:
            add(TuneKey(seam[0], tuple(shape), dtype, seam[1]))
    return keys


def staleness_check(table: TuningTable, *, budget_s: float = 60.0,
                    reps=None, target_s=None, warmup=None,
                    allow_inexact: bool = False,
                    device: str | torch.device = "cuda") -> dict:
    """Re-probe the table's worst-margin and oldest entries within
    ``budget_s`` and flag any persisted winner that no longer wins by
    more than the noise band in two probes running (a lone flag is kept
    as ``reprobed``).  Returns a report whose ``rotten`` list carries
    the fresh timings; ``ok`` is False iff it is non-empty."""
    entries = list(table.entries)
    by_margin = sorted(entries,
                       key=lambda e: (e.get("margin") is None,
                                      e.get("margin") or 0.0))
    by_age = sorted(entries, key=lambda e: e.get("measured_at") or 0.0)
    order, seen = [], set()
    for pair in zip(by_margin, by_age):
        for e in pair:
            if e["key"] not in seen:
                seen.add(e["key"])
                order.append(e)
    for e in entries:
        if e["key"] not in seen:
            order.append(e)

    def probe(e: dict) -> dict:
        fresh = measure_key(parse_key(e["key"]), reps=reps,
                            target_s=target_s, warmup=warmup,
                            allow_inexact=allow_inexact, device=device)
        fresh_ms = {n: r["ms"] for n, r in fresh["timings"].items()
                    if "ms" in r and "disqualified" not in r
                    and "ineligible" not in r}
        band = max(float(e.get("noise_band") or 0.05),
                   float(fresh["noise_band"]))
        old_winner = e["winner"]
        rec = {
            "key": e["key"],
            "persisted_winner": old_winner,
            "persisted_margin": e.get("margin"),
            "fresh_winner": fresh["winner"],
            "fresh_timings": fresh["timings"],
            "noise_band": round(band, 4),
        }
        if old_winner not in fresh_ms:
            rec["rotten"] = (f"persisted winner {old_winner!r} no longer "
                             f"qualifies: "
                             f"{fresh['timings'].get(old_winner)}")
        else:
            best = min(fresh_ms.values())
            slack = (fresh_ms[old_winner] - best) / max(best, 1e-12)
            rec["slack"] = round(slack, 4)
            if slack > band:
                rec["rotten"] = (
                    f"persisted winner {old_winner!r} now "
                    f"{fresh_ms[old_winner]:.4g} ms vs fresh best "
                    f"{fresh['winner']!r} {best:.4g} ms "
                    f"({slack:.1%} slower > {band:.1%} noise band)")
        return rec

    t0 = time.monotonic()
    results, rotten = [], []
    for e in order:
        if results and (time.monotonic() - t0) > budget_s:
            break
        rec = probe(e)
        if "rotten" in rec:
            # a load burst on one candidate's timing moves its median
            # wholesale: rot must show again in a second probe
            again = probe(e)
            rec = again if "rotten" in again else {**again,
                                                    "reprobed": rec["rotten"]}
        results.append(rec)
        if "rotten" in rec:
            rotten.append(rec)
    return {
        "ok": not rotten,
        "checked": len(results),
        "total_entries": len(entries),
        "budget_s": budget_s,
        "rotten": rotten,
        "results": results,
    }
