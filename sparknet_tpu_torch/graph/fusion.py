"""Profile-driven vertical fusion: worklist -> plan -> fused execution.

The port's own copy of ``sparknet_tpu/graph/fusion.py``, with the same
names, plan schema and ``plan_id`` hash.  ``graph/net.py`` also fuses
horizontally (sibling 1x1 convolutions, ``Net._detect_hfuse_groups``);
this module plans *vertical* conv+bias+relu(+pool/LRN) chains:

- **Worklist** (:func:`fusion_worklist`, :func:`chain_kind`): rank one
  capture's unfused chains by reclaimable ms against the capture's own
  best fused-chain bandwidth.  ``tools/perfwatch.py diff`` ships the same
  ranking as its fusion worklist.
- **Legality** (:func:`chain_candidates`): linear Conv -> [ReLU] ->
  [Pool] -> [LRN] runs where every intermediate blob has exactly one
  consumer at the produced in-place version, no member carries a loss
  weight, is stateful or draws random numbers, and no member belongs to
  a horizontal group.  Illegal chains are refused, never fused.
- **Plan** (:class:`FusionPlan`, :func:`resolve_plan`): ``SPARKNET_FUSE``
  selects the source: ``off`` (per-layer execution), ``auto`` (the
  default: the worklist of the port's own committed capture,
  ``sparknet_tpu_torch/profiles/<model>/op_table.json``, taken on the
  card by ``tools/profile_step.py``; a net without one runs unfused),
  ``all`` (every legal chain) or a ``fusion_plan.json`` path (a recorded
  plan, replayed with every chain re-validated).

Two differences from the JAX module: the pseudo-row
``trace_tables.UNATTRIBUTED`` of the port's tables is no layer, and
``auto`` never reads the root ``profiles/``, which hold the JAX
package's TPU captures.

Execution stays in ``graph/net.py`` (``Net._apply_fused_chain``): the
head convolution and any in-block member run their own layer code under
one ``L[a+b+...]`` scope, and an LRN tail runs as
``ops.vision.lrn_chain_epilogue``, the hand-written LRN kernels with a
zero-slope ReLU folded in where the chain allows it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import TYPE_CHECKING, Any, Mapping

from ..utils import knobs
from ..utils.trace_tables import UNATTRIBUTED

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .net import Net

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)

PLAN_VERSION = 1
PLAN_FILENAME = "fusion_plan.json"

# ---------------------------------------------------------------------------
# Worklist — the perfwatch `diff` chain ranking, as a library
# ---------------------------------------------------------------------------

# layers achieving more than this are bound by their arithmetic (big
# convs / FCs), not bandwidth-bound fusion candidates (the JAX name)
_MXU_GFLOPS_S = 5000.0
# the aggregation pseudo-rows: the JAX tables' and the port's
_NON_LAYERS = ("(outside layers)", UNATTRIBUTED)


def chain_kind(layer: str) -> str:
    """Classify a by_layer row name into the chain family it tails."""
    name = layer.lower()
    if "norm" in name:
        return "conv+bias+relu+LRN"
    if "pool" in name:
        return "conv+bias+relu+pool"
    if "relu" in name:
        return "bias+relu"
    return "elementwise chain"


def fusion_worklist(doc: Mapping[str, Any], *, top: int = 12,
                    min_pct: float = 0.3) -> dict:
    """Rank the unfused conv+bias+relu(+pool/LRN) chains of one capture
    by reclaimable ms against the capture's own best fused-chain
    bandwidth: a row at ``gb_per_s`` could run at the reference band, so
    ``total_ms * (1 - gb_per_s / ref)`` is what fusing it could win.

    Rows whose scope already names a fused chain (``a+b`` scopes — the
    horizontal groups and this pass's own vertical chains) are not
    candidates: they are the pass's OUTPUT.  They report under
    ``fused_chains`` with an ``at_ref_band`` verdict instead, so a
    re-capture shows each fused chain against the reference band it was
    fused to reach."""
    all_rows = [r for r in doc.get("by_layer") or []
                if r.get("op") not in _NON_LAYERS]
    rows = [r for r in all_rows
            if r.get("gb_per_s") and r.get("total_ms")]
    if not rows:
        if all_rows:
            # CPU captures attribute layers but carry no byte counts —
            # time exists, bandwidth doesn't, so a ranking against the
            # roofline would be invented numbers
            return {"note": "by_layer rows carry no bandwidth stats "
                            "(CPU runtime trace) — the worklist needs "
                            "a device capture",
                    "candidates": []}
        return {"note": "capture has no by_layer table — profile with "
                        "tools/profile_step.py to get one",
                "candidates": []}
    # reference bandwidth: the best a non-trivial chain in THIS capture
    # actually achieves (pct floor keeps sub-0.1% slivers from setting
    # an unreachable bar)
    ref_rows = [r for r in rows if (r.get("pct") or 0.0) >= 0.8]
    ref = max((r["gb_per_s"] for r in ref_rows), default=None)
    if ref is None:
        ref = max(r["gb_per_s"] for r in rows)
    candidates = []
    fused_chains = []
    for r in rows:
        gb = r["gb_per_s"]
        if "+" in r["op"]:
            if (r.get("pct") or 0.0) >= min_pct:
                fused_chains.append({
                    "chain": r["op"], "total_ms": r["total_ms"],
                    "gb_per_s": gb, "ref_gb_per_s": round(ref, 1),
                    "at_ref_band": bool(gb >= 0.95 * ref)})
            continue
        if (r.get("pct") or 0.0) < min_pct:
            continue
        if (r.get("gflops_per_s") or 0.0) > _MXU_GFLOPS_S:
            continue   # arithmetic-bound: more bandwidth buys nothing
        if gb >= 0.95 * ref:
            continue   # already at the fused-chain roofline
        reclaim = r["total_ms"] * (1.0 - gb / ref)
        kind = chain_kind(r["op"])
        cand = {"chain": r["op"], "kind": kind,
                "total_ms": r["total_ms"], "pct": r.get("pct"),
                "gb_per_s": gb, "ref_gb_per_s": round(ref, 1),
                "reclaimable_ms": round(reclaim, 2)}
        if "LRN" in kind:
            cand["note"] = ("LRN chain — fused, its tail runs as the "
                            "[ReLU+]LRN epilogue of the hand LRN kernels")
        candidates.append(cand)
    candidates.sort(key=lambda c: -c["reclaimable_ms"])
    out = {"ref_gb_per_s": round(ref, 1),
           "reclaimable_ms_total": round(
               sum(c["reclaimable_ms"] for c in candidates), 2),
           "candidates": candidates[:top]}
    if fused_chains:
        out["fused_chains"] = fused_chains
    return out


# ---------------------------------------------------------------------------
# Plan model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FusedChain:
    """One vertical chain: ``members[0]`` is the head Convolution, the
    rest follow in graph order.  ``epilogue`` names how the tail
    executes: ``"relu+lrn"`` / ``"lrn"`` run the LRN (and the folded
    ReLU) in the fused epilogue op; ``"none"`` runs every member's own
    impl inside one scope (the block exists for attribution and as the
    seam later kernels land in)."""

    members: list[str]
    kind: str
    epilogue: str = "none"
    source: dict | None = None     # the worklist row that motivated it

    def scope(self) -> str:
        return "+".join(self.members)

    def to_doc(self) -> dict:
        doc = {"members": list(self.members), "kind": self.kind,
               "epilogue": self.epilogue}
        if self.source:
            doc["source"] = dict(self.source)
        return doc


@dataclasses.dataclass
class FusionPlan:
    """What fuses, where the decision came from, and what was refused —
    the committed, reproducible record (``fusion_plan.json``)."""

    model: str
    source: str                    # "off"|"auto:<path>"|"all"|"file:<path>"
    chains: list[FusedChain] = dataclasses.field(default_factory=list)
    refused: list[dict] = dataclasses.field(default_factory=list)
    version: int = PLAN_VERSION

    def plan_id(self) -> str:
        """Short stable id for perf-ledger fingerprints: ``off`` when
        nothing fuses, else ``vf<N>-<hash of the member lists>`` — two
        captures pool into one baseline band iff they fused the same
        chains."""
        if not self.chains:
            return "off"
        canon = "|".join(sorted(";".join(c.members) for c in self.chains))
        return (f"vf{len(self.chains)}-"
                f"{hashlib.sha1(canon.encode()).hexdigest()[:8]}")

    def to_doc(self) -> dict:
        return {"version": self.version, "model": self.model,
                "source": self.source, "plan_id": self.plan_id(),
                "chains": [c.to_doc() for c in self.chains],
                "refused": list(self.refused)}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_doc(), f, indent=1)
            f.write("\n")

    @classmethod
    def from_doc(cls, doc: Mapping[str, Any]) -> "FusionPlan":
        if int(doc.get("version", 0)) > PLAN_VERSION:
            raise ValueError(
                f"fusion plan version {doc.get('version')} is newer than "
                f"this build understands ({PLAN_VERSION})")
        chains = [FusedChain(members=list(c["members"]),
                             kind=c.get("kind", "?"),
                             epilogue=c.get("epilogue", "none"),
                             source=c.get("source"))
                  for c in doc.get("chains") or []]
        return cls(model=str(doc.get("model") or "unknown"),
                   source=str(doc.get("source") or "file"),
                   chains=chains,
                   refused=list(doc.get("refused") or []))

    @classmethod
    def load(cls, path: str) -> "FusionPlan":
        with open(path) as f:
            return cls.from_doc(json.load(f))


# ---------------------------------------------------------------------------
# Legality — the statically fusable chains of a built Net
# ---------------------------------------------------------------------------

# member grammar after the head Convolution, in required order (each
# stage optional, at most one of each)
_STAGE_ORDER = ("ReLU", "Pooling", "LRN")


def _member_legal(node, train_and_test=True) -> str | None:
    """None when the node can join a chain, else the refusal reason."""
    if len(node.bottoms) != 1 or len(node.tops) != 1:
        return f"{node.lp.name}: multi-bottom/top layers don't chain"
    if node.impl.has_state:
        return f"{node.lp.name}: stateful layer"
    if node.impl.needs_rng(node.lp, True) or node.impl.needs_rng(node.lp,
                                                                 False):
        return f"{node.lp.name}: stochastic layer (needs rng)"
    if any(w for w in node.loss_weights()):
        return f"{node.lp.name}: carries a loss weight"
    return None


def _lrn_epilogue_kind(net: "Net", node) -> str | None:
    """"lrn" when this LRN member can run as the fused epilogue op,
    else None (it then runs as its own impl inside the block)."""
    p = node.lp.sub("lrn_param")
    region = str(p.get("norm_region", "ACROSS_CHANNELS"))
    shape = net.blob_shapes.get(node.bottoms[0])
    if region == "ACROSS_CHANNELS" and shape is not None and len(shape) == 4:
        return "lrn"
    return None


def _relu_foldable(node) -> bool:
    """Zero-slope ReLU folds into the LRN epilogue kernels; a leaky
    slope keeps its own (still in-block) elementwise op."""
    return float(node.lp.sub("relu_param").get("negative_slope", 0.0)) == 0.0


def chain_candidates(net: "Net") -> list[FusedChain]:
    """Every maximal legal chain in ``net``, in graph order.

    Legality (each rule keeps fused semantics identical to per-layer
    execution):

    - head is a single-bottom/single-top ``Convolution`` that is not a
      member of a horizontal 1x1-sibling group (hfuse owns those);
    - successors follow the Conv -> ReLU -> Pooling -> LRN grammar;
    - every intermediate top has exactly ONE consumer — the next chain
      member — *at the produced in-place version* (a blob re-read after
      an in-place rewrite is a different tensor; the version map is the
      same discipline hfuse uses).  Single-consumer also guarantees the
      intermediate is not a net output, so skipping its blob assignment
      in the fused run is observationally safe;
    - no member is stateful, stochastic, or loss-weighted.
    """
    hfused: set[str] = set()
    if getattr(net, "_hfuse_enabled", False):
        for members in getattr(net, "_hfuse_first", {}).values():
            hfused.update(m.lp.name for m in members)

    # versioned consumer map: (blob, version) -> consumer node indices
    ver: dict[str, int] = dict.fromkeys(net.input_blobs, 0)
    consumers: dict[tuple[str, int], list[int]] = {}
    produced_ver: dict[int, dict[str, int]] = {}   # node idx -> top vers
    for i, node in enumerate(net.nodes):
        for b in node.bottoms:
            consumers.setdefault((b, ver.get(b, 0)), []).append(i)
        produced_ver[i] = {}
        for t in node.tops:
            ver[t] = ver.get(t, 0) + 1
            produced_ver[i][t] = ver[t]

    chains: list[FusedChain] = []
    taken: set[str] = set()
    for i, node in enumerate(net.nodes):
        if node.lp.type != "Convolution" or node.lp.name in taken:
            continue
        if node.lp.name in hfused:
            continue
        if _member_legal(node) is not None:
            continue
        members = [node]
        idxs = [i]
        stage = -1   # index into _STAGE_ORDER consumed so far
        cur = node
        cur_i = i
        while True:
            top = cur.tops[0]
            cons = consumers.get((top, produced_ver[cur_i][top]), [])
            if len(cons) != 1:
                break
            nxt_i = cons[0]
            nxt = net.nodes[nxt_i]
            if nxt.lp.type not in _STAGE_ORDER:
                break
            nstage = _STAGE_ORDER.index(nxt.lp.type)
            if nstage <= stage:
                break
            if _member_legal(nxt) is not None:
                break
            if nxt.lp.name in taken or nxt.lp.name in hfused:
                break
            if (nxt.lp.type == "Pooling"
                    and str(nxt.lp.sub("pooling_param").get(
                        "pool", "MAX")) == "STOCHASTIC"):
                break   # needs_rng covers train; test mode is odd too
            members.append(nxt)
            idxs.append(nxt_i)
            stage = nstage
            cur, cur_i = nxt, nxt_i
            if nxt.lp.type == "LRN":
                break   # grammar: nothing chains past the LRN tail
        if len(members) < 2:
            continue
        kind = "conv+bias" if _conv_has_bias(members[0]) else "conv"
        epilogue = "none"
        for m in members[1:]:
            kind += {"ReLU": "+relu", "Pooling": "+pool",
                     "LRN": "+LRN"}[m.lp.type]
        tail = members[-1]
        if tail.lp.type == "LRN":
            ep = _lrn_epilogue_kind(net, tail)
            if ep:
                prev = members[-2]
                if prev.lp.type == "ReLU" and _relu_foldable(prev):
                    epilogue = "relu+lrn"
                else:
                    epilogue = "lrn"
        chains.append(FusedChain(
            members=[m.lp.name for m in members], kind=kind,
            epilogue=epilogue))
        taken.update(m.lp.name for m in members)
    return chains


def _conv_has_bias(node) -> bool:
    return bool(node.lp.sub("convolution_param").get("bias_term", True))


# ---------------------------------------------------------------------------
# Plan derivation
# ---------------------------------------------------------------------------

def plan_all(net: "Net", source: str = "all") -> FusionPlan:
    """Fuse every legal chain — the parity-gate / testing planner."""
    return FusionPlan(model=net.name or "unknown", source=source,
                      chains=chain_candidates(net))


def plan_from_profile(net: "Net", op_table: Mapping[str, Any],
                      source: str) -> FusionPlan:
    """The profile-driven planner: fuse exactly the chains the capture's
    worklist names (any member name matches — the profiled scope is
    usually the chain's LRN/pool tail), in worklist order.  Candidates
    that name no legal chain are recorded as refused with the reason —
    a hotspot the pass cannot legally fuse should be visible, not
    silently dropped."""
    cands = chain_candidates(net)
    by_member = {m: c for c in cands for m in c.members}
    wl = fusion_worklist(op_table)
    plan = FusionPlan(model=net.name or "unknown", source=source)
    seen: set[str] = set()
    for row in wl.get("candidates") or []:
        chain = by_member.get(row.get("chain"))
        if chain is None:
            plan.refused.append({
                "candidate": row.get("chain"),
                "reason": "no legal chain contains this layer "
                          "(fan-out, stateful/stochastic member, "
                          "loss-weighted top, or not in this net)"})
            continue
        key = chain.scope()
        if key in seen:
            continue
        seen.add(key)
        chain = dataclasses.replace(
            chain, source={"chain": row.get("chain"),
                           "reclaimable_ms": row.get("reclaimable_ms"),
                           "gb_per_s": row.get("gb_per_s"),
                           "ref_gb_per_s": row.get("ref_gb_per_s")})
        plan.chains.append(chain)
    return plan


def plan_from_file(net: "Net", path: str) -> FusionPlan:
    """Replay a recorded plan, re-validating every chain against the
    net's CURRENT legal set: a chain whose member list no longer
    matches a legal chain is refused (graph drift must not resurrect a
    stale fusion), everything else applies exactly as recorded."""
    loaded = FusionPlan.load(path)
    legal = {tuple(c.members): c for c in chain_candidates(net)}
    plan = FusionPlan(model=net.name or loaded.model,
                      source=f"file:{path}", refused=list(loaded.refused))
    for c in loaded.chains:
        cur = legal.get(tuple(c.members))
        if cur is None:
            plan.refused.append({
                "candidate": "+".join(c.members),
                "reason": "recorded chain is not legal in this net "
                          "(member list does not match any legal chain)"})
            continue
        plan.chains.append(dataclasses.replace(cur, source=c.source))
    return plan


# model-name -> committed profile directory (the zoo nets capitalize;
# profile dirs are the bench-model slugs)
def model_slug(name: str | None) -> str:
    return (name or "").lower().replace("_", "").replace("-", "")


_PROFILE_CACHE: dict[str, tuple[float, dict | None]] = {}


def default_profile_table(model_name: str | None,
                          pkg: str | None = None) -> tuple[dict, str] | None:
    """The port's committed ``sparknet_tpu_torch/profiles/<model>/
    op_table.json`` for a net name (``GoogleNet`` -> ``profiles/
    googlenet``), or None; never the root ``profiles/`` (the JAX
    package's TPU captures).  ``pkg`` is the package directory (the
    installed one by default).  Prefers the plain capture over suffixed
    variants so the ``auto`` plan is stable; cached by mtime.  The
    returned path is relative to the repository root."""
    pkg = pkg or _PKG_ROOT
    slug = model_slug(model_name)
    if not slug:
        return None
    pdir = os.path.join(pkg, "profiles")
    try:
        names = sorted(os.listdir(pdir))
    except OSError:
        return None
    hits = [n for n in names
            if model_slug(n) == slug or n == slug]
    # plain name first, then the shortest suffixed variant
    hits.sort(key=lambda n: (n != slug, len(n)))
    for n in hits:
        path = os.path.join(pdir, n, "op_table.json")
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            continue
        cached = _PROFILE_CACHE.get(path)
        if cached and cached[0] == mtime:
            doc = cached[1]
        else:
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                doc = None
            _PROFILE_CACHE[path] = (mtime, doc)
        if doc is not None:
            return doc, os.path.relpath(path, os.path.dirname(pkg))
    return None


def resolve_plan(net: "Net") -> FusionPlan | None:
    """Read ``SPARKNET_FUSE`` (latched at Net construction, like the
    hfuse toggle: a net keeps the plan it was built with) and build the
    plan.

    ``off``/``0`` -> None (per-layer execution); ``auto`` (default) ->
    derive from the port's committed profile worklist — models without
    a committed capture run unfused; ``all`` -> every legal chain;
    anything else -> a plan-file path."""
    env = (knobs.raw("SPARKNET_FUSE") or "auto").strip()
    if env in ("off", "0"):
        return None
    if env == "all":
        return plan_all(net)
    if env == "auto":
        hit = default_profile_table(net.name)
        if hit is None:
            return FusionPlan(model=net.name or "unknown",
                              source="auto:no-profile")
        doc, rel = hit
        return plan_from_profile(net, doc, source=f"auto:{rel}")
    if not os.path.isfile(env):
        raise ValueError(
            f"SPARKNET_FUSE={env!r}: not off|auto|all and no such plan "
            f"file — a typo here must not silently change what executes")
    return plan_from_file(net, env)
