"""The port's ledger readers of the fleet serving, net soak, rollout soak
and commbench reports against the JAX package's (F3 and its neighbours,
ROADMAP C).

``entries_from_any`` of each package on the committed root reports
``BENCH_serving_fleet_r11.json``, ``SOAK_rollout_r18.json``,
``SOAK_net_r17.json`` and ``BENCH_comm_r19.json`` gives 1, 1, 1 and 4
entries, the same in both (source, round, metrics and their values,
notes and the fingerprint but for its ``backend``, which the port reads
as ``cuda`` where the JAX package reads ``tpu``).  The reports the port's
own tools write (``serveload --fleet``, ``soak --net`` and ``--rollout``,
commbench) carry a ``device`` the JAX reports lack; the JAX readers
ignore it, and the port's readers put it in the fingerprint.  The port's
commbench and net soak reports are held the same way in
tests/test_torch_commbench.py and tests/test_torch_soak.py.
"""

from __future__ import annotations

import json
import os

import pytest

from sparknet_tpu.utils import perfledger as j_ledger
from sparknet_tpu_torch.utils import perfledger as p_ledger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORTS = {"BENCH_serving_fleet_r11.json": ("serving_fleet", 1),
           "SOAK_rollout_r18.json": ("rollout", 1),
           "SOAK_net_r17.json": ("netsoak", 1),
           "BENCH_comm_r19.json": ("commbench", 4)}


def _comparable(entry: dict) -> dict:
    fp = {k: v for k, v in entry["fp"].items() if k != "backend"}
    return {"source": entry["source"], "round": entry["round"],
            "metrics": entry["metrics"], "notes": entry.get("notes"),
            "fp": fp}


def _load(name):
    with open(os.path.join(ROOT, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_entries_equal_the_jax_packages(name):
    doc = _load(name)
    source, n = REPORTS[name]
    ours = p_ledger.entries_from_any(doc, name)
    theirs = j_ledger.entries_from_any(doc, name)
    assert len(ours) == len(theirs) == n
    assert [_comparable(e) for e in ours] == \
        [_comparable(e) for e in theirs]
    assert {e["source"] for e in ours} == {source}
    assert all(e["metrics"] for e in ours)


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_hints_and_failed_runs_are_read_alike(name):
    """A device hint lands in both fingerprints; a report whose gate
    failed is still read, with the same note."""
    doc = dict(_load(name), ok=False)
    kw = dict(device_hint="cuda/NVIDIA H100 80GB HBM3")
    ours = p_ledger.entries_from_any(doc, name, **kw)
    theirs = j_ledger.entries_from_any(doc, name, **kw)
    assert [_comparable(e) for e in ours] == \
        [_comparable(e) for e in theirs]
    if REPORTS[name][0] != "serving_fleet":
        assert all(e["notes"] for e in ours)


def test_the_port_puts_its_own_device_in_the_fingerprint():
    doc = dict(_load("BENCH_comm_r19.json"), device="cuda/NVIDIA H100")
    ours = p_ledger.entries_from_any(doc)
    theirs = j_ledger.entries_from_any(doc)
    assert {e["fp"]["device"] for e in ours} == {"cuda/NVIDIA H100"}
    assert {e["fp"]["backend"] for e in ours} == {"cuda"}
    assert {e["fp"]["device"] for e in theirs} == {"unknown"}
    assert [e["metrics"] for e in ours] == [e["metrics"] for e in theirs]


@pytest.mark.parametrize("doc", [
    {"mode": "net", "episodes": []}, {"mode": "rollout"},
    {"commbench": False}, {"metric": "serving_fleet_scaling_x",
                           "error": "no replica"}])
def test_empty_or_broken_reports_give_nothing_in_both(doc):
    assert p_ledger.entries_from_any(doc) == \
        j_ledger.entries_from_any(doc) == []


def test_the_docstring_names_only_what_still_waits():
    text = p_ledger.__doc__
    for reader in ("entries_from_serving_fleet", "entries_from_netsoak",
                   "entries_from_rollout", "entries_from_commbench"):
        assert reader in text and callable(getattr(p_ledger, reader))
    assert "rollout soak readers" not in text
    assert "pod soak's and\n  shardbench's readers wait" in text
