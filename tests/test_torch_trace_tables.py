"""The port's profiler tables (``utils/trace_tables.py``) and
``tools/profile_step.py`` on the CPU.

- ``profile_step`` on a lenet train step writes ``op_table.json`` with the
  schema of the JAX package's ``profiles/caffenet_cpu/op_table.json``
  (every top-level, summary and row key of it), into the directory it is
  given; its ``by_layer`` rows sum to ``total_ms`` within 1% (the rows'
  rounding), and every layer with params has forward and backward time.
- The card's join, on synthetic profiler events shaped as
  ``torch.profiler`` gives them on the card: a kernel joins the op whose
  ``kernels`` the profiler filed it under, a backward op its
  forward op through autograd's sequence number and forward thread, the
  forward op its ``L[...]`` range; a kernel that joins nothing lands in
  the unattributed row, and a GPU copy of a user range is not counted.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

from sparknet_tpu_torch.tools import profile_step
from sparknet_tpu_torch.utils import trace_tables
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

_REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "profiles", "caffenet_cpu", "op_table.json")


def test_profile_step_writes_the_jax_op_table_schema(tmp_path):
    out = tmp_path / "prof"
    doc = profile_step.main(["--model", "lenet", "--batch", "4", "--iters",
                             "2", "--device", "cpu", "--top", "0",
                             "--out", str(out)])
    with open(out / "op_table.json") as f:
        assert json.load(f) == json.loads(json.dumps(doc))
    with open(_REF) as f:
        ref = json.load(f)
    assert set(ref) <= set(doc)
    assert set(ref["summary"]) <= set(doc["summary"])
    for table in ("by_category", "by_op", "by_layer"):
        assert doc[table]
        for row in doc[table]:
            assert set(ref[table][0]) <= set(row)
    assert doc["plane"] == "/host:CPU"
    total = doc["total_ms"]
    assert total > 0
    assert abs(sum(r["total_ms"] for r in doc["by_layer"]) - total) \
        <= 0.01 * total
    rows = {r["op"]: r for r in doc["by_layer"]}
    for layer in ("conv1", "conv2", "ip1", "ip2"):
        assert rows[layer]["total_ms"] > rows[layer]["backward_ms"] > 0
    assert doc["summary"]["flops_per_step"] > 0
    assert doc["summary"]["mfu"] is None        # no peak for the CPU
    assert any(n.startswith("trace_") for n in os.listdir(out))


def _ev(name, id_, *, cpu=True, parent=None, seq=-1, thread=1,
        fwd_thread=0, us=(0.0, 0.0), user=False):
    return SimpleNamespace(
        name=name, id=id_, device_type="DeviceType.CPU" if cpu
        else "DeviceType.CUDA", cpu_parent=parent, sequence_nr=seq,
        thread=thread, fwd_thread=fwd_thread, kernels=[],
        time_range=SimpleNamespace(start=us[0], end=us[1]),
        is_user_annotation=user, is_async=False, device_index=0,
        self_cpu_time_total=us[1] - us[0])


def _launch(op, kernel):
    """The profiler's join of a device activity to its launching op."""
    op.kernels.append(SimpleNamespace(
        name=kernel.name, device=0,
        duration=kernel.time_range.end - kernel.time_range.start))


def _card_profile(drop: str | None = None):
    """norm1's forward and backward, an update op and a stray kernel, as
    the profiler reports them on the card."""
    rng = _ev("L[norm1]", 1, user=True, us=(0, 100))
    fwd = _ev("LRNAcrossChannels", 2, parent=rng, seq=5, us=(1, 50))
    root = _ev("autograd::engine::evaluate_function: "
               "LRNAcrossChannelsBackward", 3, seq=5, thread=2,
               fwd_thread=1, us=(200, 300))
    bwd = _ev("LRNAcrossChannelsBackward", 4, parent=root, seq=5, thread=2,
              fwd_thread=1, us=(201, 299))
    upd = _ev("aten::add_", 5, us=(400, 410))
    kernels = [
        (fwd, _ev("lrn_fwd_kernel<float, true, 5, 4>", 100, cpu=False,
                  us=(1000, 1030))),
        (bwd, _ev("lrn_bwd_kernel<float, 5>", 101, cpu=False,
                  us=(1100, 1150))),
        (upd, _ev("vectorized_elementwise_kernel", 102, cpu=False,
                  us=(1200, 1207))),
        (None, _ev("stray_kernel", 103, cpu=False, us=(1300, 1302))),
        (rng, _ev("L[norm1]", 104, cpu=False, user=True, us=(1000, 1030))),
    ]
    events = [rng, fwd, root, bwd, upd]
    for op, k in kernels:
        if drop is None or drop not in k.name:
            events.append(k)
            if op is not None:
                _launch(op, k)
    return SimpleNamespace(events=lambda: events)


def test_card_join_through_correlation_and_sequence_numbers():
    t = trace_tables.op_tables(_card_profile(), top=None)
    assert t["plane"] == "/device:GPU:0"
    assert t["total_ms"] == 0.089
    layers = {r["op"]: r for r in t["by_layer"]}
    assert layers["norm1"]["total_ms"] == 0.08
    assert layers["norm1"]["backward_ms"] == 0.05
    assert layers["norm1"]["count"] == 2
    assert layers[trace_tables.UNATTRIBUTED]["total_ms"] == 0.009
    assert layers[trace_tables.UNATTRIBUTED]["count"] == 2
    cats = {r["op"]: r["total_ms"] for r in t["by_category"]}
    assert cats == {"LRNAcrossChannelsBackward": 0.05,
                    "LRNAcrossChannels": 0.03, "aten::add_": 0.007,
                    trace_tables.UNATTRIBUTED: 0.002}
    ops = {r["op"]: r["count"] for r in t["by_op"]}
    assert ops["lrn_bwd_kernel<float, 5>"] == 1
    assert "L[norm1]" not in ops
    # a trace that lost one kernel's events shows it in the counts
    dropped = trace_tables.op_tables(_card_profile(drop="lrn_bwd"))
    assert "lrn_bwd_kernel<float, 5>" not in {r["op"]
                                             for r in dropped["by_op"]}
    assert {r["op"]: r for r in dropped["by_layer"]}["norm1"][
        "backward_ms"] == 0.0
    assert "by layer" in trace_tables.format_tables(t)
