"""The port's profiler server (``utils/profiling.py::server``), the
counterpart of the JAX package's ``profiling.server``, on the CPU.

One capture over a served lenet forward answers with a Chrome trace that
holds the serving thread's ``L[layer]`` ranges; a second capture while
one records, a capture inside ``trace()`` and one while any
``torch.profiler`` records answer 409 (``ProfilerBusy``); a bad window is
a 400 and an unknown path a 404."""

from __future__ import annotations

import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.parallel.serving import (InferenceEngine,
                                                 ModelHouse, ServeConfig)
from sparknet_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

LENET_LAYERS = {"L[conv1]", "L[pool1]", "L[conv2]", "L[ip1]", "L[ip2]"}


@pytest.fixture
def engine():
    cfg = ServeConfig(batch_shapes=(1, 4), max_delay_ms=1.0, dtype="f32")
    house = ModelHouse(cfg, device="cpu")
    lm = house.load("lenet")
    with InferenceEngine(house, cfg) as eng:
        yield eng, lm


def _serve_until(eng, lm, stop: threading.Event) -> threading.Thread:
    def load():
        x = np.zeros(lm.in_shape, np.float32)
        while not stop.is_set():
            eng.classify("lenet", x)
    t = threading.Thread(target=load, daemon=True)
    t.start()
    return t


def test_a_capture_holds_the_serving_threads_layer_ranges(engine):
    eng, lm = engine
    stop = threading.Event()
    with profiling.server(0) as srv:
        t = _serve_until(eng, lm, stop)
        try:
            doc = profiling.fetch_capture(srv.url, 300)
        finally:
            stop.set()
            t.join(timeout=30)
    assert not t.is_alive()
    names = {e.get("name") for e in doc["traceEvents"]}
    assert LENET_LAYERS <= names, sorted(n for n in names if n)[:40]
    assert doc["otherData"]["all_threads"] is True
    assert doc["otherData"]["capture_ms"] == 300.0
    assert not profiling._capturing.is_set() and not profiling._sessions


def test_a_second_capture_is_refused_with_409(engine):
    eng, lm = engine
    stop = threading.Event()
    second = {}

    def again(url):
        time.sleep(0.1)
        try:
            profiling.fetch_capture(url, 20)
            second["result"] = "captured"
        except profiling.ProfilerBusy as e:
            second["result"] = str(e)

    with profiling.server(0) as srv:
        t = _serve_until(eng, lm, stop)
        t2 = threading.Thread(target=again, args=(srv.url,))
        t2.start()
        try:
            doc = profiling.fetch_capture(srv.url, 400)
        finally:
            t2.join(timeout=30)
            stop.set()
            t.join(timeout=30)
        assert '"ProfilerBusy"' in second["result"]
        assert doc["traceEvents"]
        # the first capture over, the next one records
        assert profiling.fetch_capture(srv.url, 5)["traceEvents"] is not None


def test_a_capture_inside_trace_is_refused(tmp_path):
    with profiling.server(0) as srv:
        with profiling.trace(str(tmp_path)):
            with pytest.raises(profiling.ProfilerBusy):
                profiling.fetch_capture(srv.url, 10)
        assert profiling.fetch_capture(srv.url, 5)
    with profiling.trace(str(tmp_path)):          # server started inside
        with profiling.server(0) as srv:
            with pytest.raises(profiling.ProfilerBusy):
                profiling.fetch_capture(srv.url, 10)


def test_a_capture_while_any_torch_profiler_records_is_refused():
    with profiling.server(0) as srv:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        with prof:
            with pytest.raises(profiling.ProfilerBusy):
                profiling.fetch_capture(srv.url, 10)
        assert not profiling._sessions
        assert profiling.fetch_capture(srv.url, 5)


@pytest.mark.parametrize("path, code", [("/capture?ms=0", 400),
                                        ("/capture?ms=abc", 400),
                                        ("/capture?ms=99999999", 400),
                                        ("/nope", 404)])
def test_bad_requests(path, code):
    with profiling.server(0) as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + path, timeout=30)
        assert e.value.code == code


def test_layer_scope_is_free_outside_a_capture():
    assert not profiling._capturing.is_set()
    assert type(profiling.layer_scope("conv1")).__name__ == "nullcontext"
    profiling._capturing.set()
    try:
        assert isinstance(profiling.layer_scope("conv1"), profiling.annotate)
    finally:
        profiling._capturing.clear()
