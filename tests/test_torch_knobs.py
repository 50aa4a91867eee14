"""The port's knob registry (``sparknet_tpu_torch/utils/knobs.py``) and
its reference (``sparknet_tpu_torch/KNOBS.md``) against the JAX
package's registry, on the CPU.

For every name both registries hold: the same type and default, and the
same accessor result (exact equality) on the same environment; the same
exception types on a bad value, an unknown name and a tombstone.  Every
``SPARKNET_*`` literal under ``sparknet_tpu_torch/`` is registered, each
owner is a module of the port, and ``KNOBS.md`` is ``knobs_md()``
(``tools/knobs --check``)."""

from __future__ import annotations

import pathlib
import re

import pytest

from sparknet_tpu.utils import knobs as jknobs
from sparknet_tpu_torch.tools import knobs as knobs_tool
from sparknet_tpu_torch.utils import knobs

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "sparknet_tpu_torch"

SHARED = sorted({k.name for k in knobs.all_knobs()}
                & {k.name for k in jknobs.all_knobs()})
LIVE_SHARED = [n for n in SHARED if not knobs._REGISTRY[n].removed]
TOMBSTONES = [k.name for k in jknobs.all_knobs() if k.removed]

# a set value of each type, and the accessor that reads it
VALUES = {"int": "7", "float": "2.5", "bool": "1", "str": "x",
          "enum": "off", "path": "/tmp/x", "spec": "a=1"}


def _accessor(mod, kind: str):
    return {"int": lambda n: mod.get_int(n, -1),
            "float": lambda n: mod.get_float(n, -1.0),
            "bool": lambda n: mod.get_bool(n, False)}.get(
                kind, lambda n: mod.get_str(n, "dflt"))


def test_the_registries_share_every_knob_the_port_reads_from_jax():
    # the port's own reads are all JAX names: nothing port-only
    assert {k.name for k in knobs.all_knobs()} <= \
        {k.name for k in jknobs.all_knobs()}
    assert len(SHARED) >= 54


@pytest.mark.parametrize("name", SHARED)
def test_same_type_and_default(name):
    mine, theirs = knobs._REGISTRY[name], jknobs._REGISTRY[name]
    assert (mine.type, mine.default) == (theirs.type, theirs.default)
    assert bool(mine.removed) == bool(theirs.removed)
    assert mine.doc and "\n" not in mine.doc


@pytest.mark.parametrize("name", LIVE_SHARED)
@pytest.mark.parametrize("state", ["unset", "set"])
def test_same_accessor_result(monkeypatch, name, state):
    kind = knobs.get(name).type
    if state == "unset":
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, VALUES[kind])
    assert _accessor(knobs, kind)(name) == _accessor(jknobs, kind)(name)
    assert knobs.raw(name) == jknobs.raw(name)
    assert knobs.is_set(name) == jknobs.is_set(name)


@pytest.mark.parametrize("kind, name", [("int", "SPARKNET_SERVE_QUEUE"),
                                        ("float", "SPARKNET_SLO_FAST_S")])
def test_bad_values_raise_the_same_types(monkeypatch, kind, name):
    monkeypatch.setenv(name, "not-a-number")
    errs = []
    for mod in (knobs, jknobs):
        with pytest.raises(mod.InvalidKnobValue) as e:
            _accessor(mod, kind)(name)
        errs.append(e.value)
    assert [type(e).__name__ for e in errs] == ["InvalidKnobValue"] * 2
    assert isinstance(errs[0], (ValueError, knobs.KnobError))
    assert str(errs[0]) == str(errs[1])


def test_unknown_names_raise_the_same_types():
    for mod in (knobs, jknobs):
        with pytest.raises(mod.UnknownKnob):
            mod.raw("SPARKNET_NO_SUCH_KNOB")
        with pytest.raises(KeyError):
            mod.get_int("SPARKNET_NO_SUCH_KNOB", 0)


@pytest.mark.parametrize("name", TOMBSTONES)
def test_tombstones_raise_removed(name):
    assert knobs._REGISTRY[name].removed == jknobs._REGISTRY[name].removed
    for mod in (knobs, jknobs):
        with pytest.raises(mod.RemovedKnob, match="removed"):
            mod.raw(name)
    assert issubclass(knobs.RemovedKnob, (KeyError, knobs.KnobError))


def _literals() -> dict[str, list[str]]:
    """``SPARKNET_*`` literals under the port by file (a name ending in
    ``_`` is a prefix in prose, ``SPARKNET_IO_*``)."""
    found: dict[str, list[str]] = {}
    for path in sorted(PKG.rglob("*.py")):
        for name in re.findall(r"SPARKNET_[A-Z0-9_]+", path.read_text()):
            if not name.endswith("_"):
                found.setdefault(name, []).append(
                    str(path.relative_to(ROOT)))
    return found


def test_every_knob_literal_of_the_port_is_registered():
    literals = _literals()
    assert "SPARKNET_FUSE" in literals and "SPARKNET_TUNE" in literals
    missing = {n: f for n, f in literals.items() if n not in knobs._REGISTRY}
    assert not missing, missing


def test_every_live_knob_is_read_by_its_owner():
    literals = _literals()
    for k in knobs.all_knobs():
        assert k.owner.startswith("sparknet_tpu_torch/"), k
        assert (ROOT / k.owner).is_file(), k
        if not k.removed:
            assert k.name in literals, f"{k.name} is registered, never named"


def test_refused_jax_names_say_so_and_raise(monkeypatch):
    from sparknet_tpu_torch.parallel.trainer import comm_config_from_env
    for name in ("SPARKNET_SHARD", "SPARKNET_SHARD_CKPT"):
        assert "A12" in knobs.get(name).doc
        monkeypatch.setenv(name, "1")
        with pytest.raises(NotImplementedError, match="A12"):
            comm_config_from_env()
        monkeypatch.delenv(name)


def test_knobs_view_and_duplicate_registration():
    assert knobs.KNOBS == {k.name: k.doc for k in knobs.all_knobs()
                           if not k.removed}
    with pytest.raises(ValueError, match="duplicate"):
        knobs._register(knobs.get("SPARKNET_FUSE"))


def test_knobs_md_is_the_registry(capsys):
    assert (PKG / "KNOBS.md").read_text() == knobs.knobs_md()
    assert knobs_tool.main(["--check"]) == 0
    md = knobs.knobs_md()
    for k in knobs.all_knobs():
        assert f"`{k.name}`" in md
    assert "## Removed (tombstones)" in md
    assert "in sync" in capsys.readouterr().out


def test_knobs_tool_emits_and_catches_drift(tmp_path, monkeypatch, capsys):
    target = tmp_path / "KNOBS.md"
    monkeypatch.setattr(knobs_tool, "KNOBS_MD", target)
    assert knobs_tool.main(["--check"]) == 1          # missing
    assert knobs_tool.main(["--emit"]) == 0
    assert target.read_text() == knobs.knobs_md()
    assert knobs_tool.main(["--check"]) == 0
    target.write_text(target.read_text().replace("SPARKNET_TAU", "X", 1))
    assert knobs_tool.main(["--check"]) == 1          # drifted
    assert "stale" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        knobs_tool.main([])                           # a mode is required
