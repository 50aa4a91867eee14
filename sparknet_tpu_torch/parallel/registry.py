"""Immutable, content-hashed model registry: the serving plane's source
of truth for which weights a version id means.

The port's own copy of ``sparknet_tpu/parallel/registry.py``, with the
same on-disk layout, manifest schema and content hash, so each package
reads the registry the other wrote and a version id names the same bytes
in both.  A **version** is an immutable bundle (weights, the tuning-table
and fusion-plan ids it was validated against, the SLO it declares, and
provenance) addressed by the hash of that content.

Publication discipline:

- the bundle directory fills first, and the **manifest rename is the
  publication fence**: a reader sees a complete version or none;
- manifests are schema-versioned; one written by a newer build, or
  missing required fields, is refused with a ``ValueError``;
- publishing identical content again is a typed :class:`DuplicateVersion`,
  and resolving an unpublished id a typed :class:`UnknownVersion`.

Routing truth lives in one file per model: ``channels.json`` holds the
``stable`` and ``canary`` pointers and the canary traffic weight, written
atomically.

Versioned serving names are ``model@version``; :func:`versioned` and
:func:`split_versioned` are the one place that spelling lives.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any, Mapping

from ..utils import knobs

__all__ = [
    "MANIFEST_VERSION", "UnknownVersion", "DuplicateVersion",
    "ModelRegistry", "active_registry", "versioned", "split_versioned",
]

MANIFEST_VERSION = 1
CHANNELS_VERSION = 1


class UnknownVersion(KeyError):
    """A lookup of a version id the registry never published."""

    def __str__(self) -> str:  # KeyError quotes its arg; keep it readable
        return self.args[0] if self.args else ""


class DuplicateVersion(ValueError):
    """Publishing content that already exists — versions are immutable,
    so the existing id IS the answer (it rides in ``.version``)."""

    def __init__(self, model: str, version: str):
        self.model = model
        self.version = version
        super().__init__(
            f"model {model!r} already has version {version} with this "
            f"exact content — versions are immutable; reuse the id")


def versioned(model: str, version: str) -> str:
    """The serving name of one published version: ``model@version``."""
    return f"{model}@{version}"


def split_versioned(name: str) -> tuple[str, str | None]:
    """``"lenet@mv3-..."`` -> ``("lenet", "mv3-...")``; plain names get
    ``(name, None)``."""
    base, sep, ver = name.partition("@")
    return (base, ver) if sep else (name, None)


def _atomic_json(path: str, doc: Mapping[str, Any]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _sha256_file(path: str) -> tuple[str, int]:
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            h.update(chunk)
            n += len(chunk)
    return h.hexdigest(), n


class ModelRegistry:
    """One registry rooted at a directory (see module docstring).

    Layout::

        <root>/<model>/<version>/manifest.json   (the publication fence)
        <root>/<model>/<version>/weights.npz     (copied bundle, if any)
        <root>/<model>/channels.json             (stable/canary pointers)
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    # -- publication ------------------------------------------------------
    def publish(self, model: str, *, weights: str | None = None,
                tuning_table: str | None = None,
                fusion_plan: str | None = None,
                slo: Mapping[str, Any] | None = None,
                notes: str = "") -> str:
        """Publish one immutable version; returns its content-hashed id.

        ``weights`` (a ``.npz``/``.caffemodel`` path) is copied into the
        bundle — the registry owns its bytes, the source file may rot.
        ``weights=None`` publishes a zoo-init version (deterministic
        seed-init weights; identity then hangs on the metadata alone).
        Identical content raises :class:`DuplicateVersion` carrying the
        existing id.
        """
        if "@" in model or "/" in model:
            raise ValueError(f"bad model name {model!r} — '@' and '/' "
                             f"are reserved (versioned-name grammar)")
        identity: dict[str, Any] = {
            "model": model, "tuning_table": tuning_table,
            "fusion_plan": fusion_plan,
            "slo": dict(slo) if slo else None, "notes": notes,
        }
        w_meta = None
        if weights is not None:
            sha, nbytes = _sha256_file(weights)
            w_meta = {"file": "weights" + (os.path.splitext(weights)[1]
                                           or ".npz"),
                      "sha256": sha, "bytes": nbytes}
            identity["weights_sha256"] = sha
        h = hashlib.sha256(json.dumps(identity, sort_keys=True)
                           .encode()).hexdigest()
        vid = f"mv-{h[:12]}"
        vdir = os.path.join(self.root, model, vid)
        manifest_path = os.path.join(vdir, "manifest.json")
        if os.path.exists(manifest_path):
            raise DuplicateVersion(model, vid)
        from ..utils import perfledger
        os.makedirs(vdir, exist_ok=True)
        if weights is not None:
            shutil.copyfile(weights, os.path.join(vdir, w_meta["file"]))
        doc = {
            "kind": "model_version",
            "version": MANIFEST_VERSION,
            "model": model,
            "id": vid,
            "weights": w_meta,
            "tuning_table": tuning_table,
            "fusion_plan": fusion_plan,
            "slo": dict(slo) if slo else None,
            "notes": notes,
            "published_at": time.time(),
            "provenance": perfledger.provenance(),
        }
        _atomic_json(manifest_path, doc)   # the publication fence
        return vid

    # -- lookup -----------------------------------------------------------
    def manifest(self, model: str, version: str) -> dict[str, Any]:
        path = os.path.join(self.root, model, version, "manifest.json")
        try:
            with open(path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            raise UnknownVersion(
                f"model {model!r} has no version {version!r} "
                f"(published: {self.versions(model) or '[]'})") from None
        except ValueError as e:
            raise ValueError(f"{path}: unparseable manifest ({e}) — "
                             f"refusing") from e
        return self._check_manifest(doc, model, version, origin=path)

    @staticmethod
    def _check_manifest(doc: Any, model: str, version: str,
                        origin: str = "<doc>") -> dict[str, Any]:
        if not isinstance(doc, dict) or doc.get("kind") != "model_version":
            raise ValueError(
                f"{origin}: not a model-version manifest (kind="
                f"{doc.get('kind') if isinstance(doc, dict) else type(doc)})")
        ver = doc.get("version")
        if not isinstance(ver, int):
            raise ValueError(f"{origin}: manifest has no integer schema "
                             f"version — refusing a drifted file")
        if ver > MANIFEST_VERSION:
            raise ValueError(
                f"{origin}: manifest schema v{ver} is newer than this "
                f"build understands (v{MANIFEST_VERSION}) — refusing to "
                f"guess")
        if doc.get("model") != model or doc.get("id") != version:
            raise ValueError(
                f"{origin}: manifest names {doc.get('model')!r}/"
                f"{doc.get('id')!r}, not {model!r}/{version!r} — a moved "
                f"bundle is a corrupted bundle, refusing")
        w = doc.get("weights")
        if w is not None and not (isinstance(w, dict)
                                  and isinstance(w.get("file"), str)
                                  and isinstance(w.get("sha256"), str)):
            raise ValueError(f"{origin}: manifest weights entry missing "
                             f"file/sha256 — refusing a drifted file")
        return doc

    def versions(self, model: str) -> list[str]:
        """Published (manifest-fenced) version ids, sorted."""
        mdir = os.path.join(self.root, model)
        try:
            names = os.listdir(mdir)
        except OSError:
            return []
        return sorted(
            v for v in names
            if os.path.exists(os.path.join(mdir, v, "manifest.json")))

    def weights_path(self, model: str, version: str) -> str | None:
        """Absolute path of the bundled weights, their sha256 checked
        against the manifest, or None for a zoo-init version."""
        man = self.manifest(model, version)
        w = man.get("weights")
        if w is None:
            return None
        path = os.path.join(self.root, model, version, w["file"])
        sha, _ = _sha256_file(path)
        if sha != w["sha256"]:
            raise ValueError(
                f"{path}: weight bytes do not match the manifest sha256 "
                f"— the bundle rotted on disk, refusing to serve it")
        return path

    # -- channels (the single source of routing truth) --------------------
    def channels(self, model: str) -> dict[str, Any]:
        """``{"stable": id|None, "canary": id|None, "weight": f}`` —
        never-routed models read as all-None/0 (no channel file is a
        valid state, an unparseable one is not)."""
        path = os.path.join(self.root, model, "channels.json")
        try:
            with open(path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return {"stable": None, "canary": None, "weight": 0.0}
        except ValueError as e:
            raise ValueError(f"{path}: unparseable channel file ({e}) — "
                             f"refusing") from e
        if not isinstance(doc, dict) or doc.get("kind") != "model_channels":
            raise ValueError(f"{path}: not a channel file — refusing")
        ver = doc.get("version")
        if not isinstance(ver, int) or ver > CHANNELS_VERSION:
            raise ValueError(f"{path}: channel schema "
                             f"{ver!r} unknown to this build (v"
                             f"{CHANNELS_VERSION}) — refusing to guess")
        return {"stable": doc.get("stable"), "canary": doc.get("canary"),
                "weight": float(doc.get("weight") or 0.0)}

    _KEEP = object()

    def set_channels(self, model: str, *, stable: Any = _KEEP,
                     canary: Any = _KEEP,
                     weight: Any = _KEEP) -> dict[str, Any]:
        """Read-modify-write the channel pointers atomically.  Pointed
        versions must be published (None clears a pointer) — a channel
        file may never name bytes that do not exist."""
        cur = self.channels(model)
        if stable is not ModelRegistry._KEEP:
            cur["stable"] = stable
        if canary is not ModelRegistry._KEEP:
            cur["canary"] = canary
        if weight is not ModelRegistry._KEEP:
            w = float(weight)
            if not 0.0 <= w <= 1.0:
                raise ValueError(f"canary weight must be in [0, 1], "
                                 f"got {w}")
            cur["weight"] = w
        for ch in ("stable", "canary"):
            if cur[ch] is not None:
                self.manifest(model, cur[ch])   # UnknownVersion if not
        if cur["canary"] is None:
            cur["weight"] = 0.0
        _atomic_json(os.path.join(self.root, model, "channels.json"), {
            "kind": "model_channels", "version": CHANNELS_VERSION,
            "model": model, "t": time.time(), **cur})
        return cur

    def resolve(self, model: str, channel: str = "stable") -> str:
        """The version id a channel points at (typed when unrouted)."""
        ch = self.channels(model)
        vid = ch.get(channel)
        if vid is None:
            raise UnknownVersion(
                f"model {model!r} has no {channel!r} channel pointer "
                f"(channels: {ch})")
        return vid

    def channel_of(self, model: str, version: str) -> str | None:
        """``"stable"`` / ``"canary"`` / None for one version id."""
        ch = self.channels(model)
        if ch.get("stable") == version:
            return "stable"
        if ch.get("canary") == version:
            return "canary"
        return None


def active_registry() -> ModelRegistry | None:
    """The registry named by ``SPARKNET_REGISTRY_DIR``, or None when the
    deployment plane is not configured (plain by-name serving)."""
    root = knobs.raw("SPARKNET_REGISTRY_DIR")
    if not root:
        return None
    return ModelRegistry(root)
