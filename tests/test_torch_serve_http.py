"""The port's HTTP shell (``sparknet_tpu_torch/tools/serve.py``),
``RemoteClassifier`` and ``classify_cli --server`` against the JAX
package's, on the CPU.

The port's server runs as a user runs it, ``python -m
sparknet_tpu_torch.tools.serve --device cpu`` in a subprocess, on lenet
with one ``.caffemodel`` (drawn by the port); the JAX shell
(``tools/serve.py``'s ``make_handler``) serves the same file from a JAX
engine in this process.  The same requests (tests/test_serving.py:570-637
and the rest of the endpoints) get the same HTTP statuses and the same
JSON keys from both, and probabilities within 1e-5 of each other;
``/metrics`` carries the same metric names.  A registry version the JAX
package published loads over ``/v1/models/load`` and serves when pinned
by ``version``.  ``classify_cli --server`` gives the local CLI's
probabilities within 1e-5.  Without ``--device cpu`` and without a card
the server refuses to run, ``--fleet`` included (the fleet itself is
held in tests/test_torch_fleet_serving.py).
"""

from __future__ import annotations

import base64
import importlib.util
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from sparknet_tpu.parallel import registry as jax_registry
from sparknet_tpu.parallel import serving as jax_serving
from sparknet_tpu.utils import telemetry as jax_telemetry
from sparknet_tpu_torch import classify
from sparknet_tpu_torch.graph.net import Net
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.parallel import serving
from sparknet_tpu_torch.proto import NetState, Phase
from sparknet_tpu_torch.proto.caffemodel import save_caffemodel
from sparknet_tpu_torch.proto.textformat import serialize
from sparknet_tpu_torch.tools import classify_cli
from sparknet_tpu_torch.tools import serve as port_serve

from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROB_TOL = 1e-5


def _jax_serve_module():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_serve", ROOT / "tools" / "serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _request(url: str, payload=None, raw: bytes | None = None):
    """(status, JSON body) of one request, errors included."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _metrics(url: str) -> set[str]:
    with urllib.request.urlopen(f"{url}/metrics", timeout=60) as resp:
        text = resp.read().decode()
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def _x(seed: int, shape=(1, 28, 28)) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _classify_payload(x: np.ndarray, **kw) -> dict:
    return {"model": "lenet", "shape": list(x.shape), "dtype": "float32",
            "data_b64": base64.b64encode(x.tobytes()).decode(), **kw}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The port's server (a subprocess) and the JAX shell (in process)
    on one weights file and one registry the JAX package published."""
    d = tmp_path_factory.mktemp("serve")
    deploy, _ = serving.deploy_from(lenet(1, 1), 1)
    net = Net(deploy, NetState(Phase.TEST))
    params = net.init(torch.Generator().manual_seed(7), device="cpu")
    weights = str(d / "lenet.caffemodel")
    save_caffemodel(weights, {k: [b.numpy() for b in v]
                              for k, v in params.items()})
    (d / "deploy.prototxt").write_text(serialize(deploy.to_pmsg()))
    reg_dir = str(d / "reg")
    vid = jax_registry.ModelRegistry(reg_dir).publish(
        "lenet", weights=weights, slo={"p99_ms": 5000.0})
    jax_registry.ModelRegistry(reg_dir).set_channels("lenet", stable=vid)

    env = dict(os.environ, SPARKNET_HEARTBEAT_DIR=str(d / "beats"),
               SPARKNET_PROC_ID="0", SPARKNET_REGISTRY_DIR=reg_dir,
               OMP_NUM_THREADS="1")
    for k in ("SPARKNET_FAULT", "SPARKNET_TRACE_DIR", "SPARKNET_TELEMETRY"):
        env.pop(k, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparknet_tpu_torch.tools.serve",
         "--models", f"lenet={weights}", "--port", "0", "--dtype", "f32",
         "--shapes", "1,4", "--max-delay-ms", "3", "--quota", "capped=1",
         "--device", "cpu", "--endpoint-file", str(d / "endpoint.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        cwd=ROOT)
    saved = os.environ.get("SPARKNET_REGISTRY_DIR")
    os.environ["SPARKNET_REGISTRY_DIR"] = reg_dir
    jax_telemetry.reset()
    jserve = _jax_serve_module()
    cfg = jax_serving.ServeConfig(batch_shapes=(1, 4), max_delay_ms=3.0,
                                  dtype="f32", tenant_qps={"capped": 1.0})
    house = jax_serving.ModelHouse(cfg)
    house.load("lenet", weights=weights)
    engine = jax_serving.InferenceEngine(house, cfg)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                jserve.make_handler(engine, house))
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        ready = proc.stdout.readline().strip()
        assert ready.startswith("serving on http://"), (
            ready, proc.stderr.read() if proc.poll() is not None else "")
        yield {"port": ready.split()[2],
               "jax": "http://127.0.0.1:%d" % httpd.server_address[1],
               "proc": proc, "dir": d, "weights": weights, "vid": vid,
               "jax_house": house}
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
        jax_telemetry.reset()
        if saved is None:
            os.environ.pop("SPARKNET_REGISTRY_DIR", None)
        else:
            os.environ["SPARKNET_REGISTRY_DIR"] = saved
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)


def _both(served, path, payload=None, raw=None):
    return (_request(served["port"] + path, payload, raw),
            _request(served["jax"] + path, payload, raw))


# requests after which both servers must answer alike: (path, payload)
SAME_ANSWERS = {
    "classify": ("/v1/classify", _classify_payload(_x(0))),
    "classify_lists": ("/v1/classify", {"model": "lenet",
                                        "data": _x(1).tolist()}),
    "classify_uint8": ("/v1/classify", {
        "model": "lenet", "shape": [1, 28, 28], "dtype": "uint8",
        "data_b64": base64.b64encode(
            np.arange(784, dtype=np.uint8).tobytes()).decode()}),
    "unknown_model": ("/v1/classify", {**_classify_payload(_x(2)),
                                       "model": "nope"}),
    "bad_shape": ("/v1/classify", _classify_payload(_x(3, (1, 27, 28)))),
    "no_data": ("/v1/classify", {"model": "lenet"}),
    "no_route_post": ("/v1/nope", {}),
    "evict_absent": ("/v1/models/evict", {"name": "cifar10_full"}),
    "load_unknown": ("/v1/models/load", {"name": "resnet"}),
    "load_no_name": ("/v1/models/load", {}),
    "version_unknown": ("/v1/models/load", {"model": "lenet",
                                            "version": "mv-ghost"}),
}


@pytest.mark.parametrize("case", sorted(SAME_ANSWERS))
def test_same_status_keys_and_probs_as_the_jax_shell(served, case):
    path, payload = SAME_ANSWERS[case]
    (sa, a), (sb, b) = _both(served, path, payload)
    assert sa == sb, (case, a, b)
    assert sorted(a) == sorted(b), (case, a, b)
    if "probs" in a:
        assert (a["batch_n"], a["padded_to"]) == (1, 1)
        np.testing.assert_allclose(a["probs"], b["probs"], rtol=0,
                                   atol=PROB_TOL)
        assert a["top"] == int(np.argmax(a["probs"])) == b["top"]
        assert a["total_ms"] >= a["infer_ms"] >= 0


@pytest.mark.parametrize("path", ["/healthz", "/slo", "/v1/models",
                                  "/nope"])
def test_get_endpoints_answer_like_the_jax_shell(served, path):
    (sa, a), (sb, b) = _both(served, path)
    assert sa == sb, (a, b)
    if path == "/healthz":
        # the port adds the per-shape batch times to the JAX keys
        assert set(b) <= set(a) and set(a) - set(b) == {"batch_ms"}
        assert a["alive"] and a["slo"] == {"state": "ok", "breaches": 0}
    elif path == "/slo":
        assert sorted(a) == sorted(b)
        assert a["state"] == "ok" and a["declared"] == b["declared"]
    elif path == "/v1/models":
        info = a["models"]["lenet"]
        jinfo = b["models"]["lenet"]
        # the port reports its device and warm-up seconds where the JAX
        # package reports its compile seconds
        assert set(info) - set(jinfo) == {"device", "warmup_s"}
        assert set(jinfo) - set(info) == {"compile_s"}
        for k in ("in_shape", "classes", "dtype", "batch_shapes",
                  "param_mb", "version", "weights"):
            assert info[k] == jinfo[k], k
    else:
        assert sorted(a) == sorted(b)


def test_bad_json_is_400_on_both(served):
    (sa, a), (sb, b) = _both(served, "/v1/classify", raw=b"{nope")
    assert sa == sb == 400 and sorted(a) == sorted(b) == ["error"]


def test_tenant_cap_is_429_over_the_wire(served):
    statuses = {}
    for name, url in (("port", served["port"]), ("jax", served["jax"])):
        got = [_request(f"{url}/v1/classify",
                        _classify_payload(_x(4), tenant="capped"))
               for _ in range(4)]
        statuses[name] = [s for s, _ in got]
        rejected = [body for s, body in got if s == 429]
        assert rejected and all(b["reason"] == "tenant_rate"
                                for b in rejected)
    assert 429 in statuses["port"] and 429 in statuses["jax"]


def test_hot_load_evict_and_registry_version(served):
    url, vid = served["port"], served["vid"]
    s, body = _request(f"{url}/v1/models/load", {"name": "cifar10_quick"})
    assert s == 200 and body["loaded"]["name"] == "cifar10_quick"
    s, body = _request(f"{url}/v1/models/evict", {"name": "cifar10_quick"})
    assert (s, body["evicted"]) == (200, True)
    (sa, a), (sb, b) = _both(served, "/v1/models/load",
                             {"model": "lenet", "version": vid})
    assert sa == sb == 200
    assert a["loaded"]["name"] == b["loaded"]["name"] == f"lenet@{vid}"
    assert a["loaded"]["version"] == vid
    (sa, a), (sb, b) = _both(served, "/v1/classify",
                             _classify_payload(_x(5), version=vid))
    assert sa == sb == 200 and a["model"] == f"lenet@{vid}"
    np.testing.assert_allclose(a["probs"], b["probs"], rtol=0,
                               atol=PROB_TOL)
    # the version's weights are the by-name model's: the same rows
    s, plain = _request(f"{url}/v1/classify", _classify_payload(_x(5)))
    np.testing.assert_array_equal(a["probs"], plain["probs"])
    (sa, a), (sb, b) = _both(served, "/v1/models")
    assert a["models"][f"lenet@{vid}"]["channel"] == "stable" \
        == b["models"][f"lenet@{vid}"]["channel"]


def test_metrics_names_equal_the_jax_shell(served):
    _both(served, "/v1/classify", _classify_payload(_x(6)))
    _both(served, "/slo")
    mine, theirs = _metrics(served["port"]), _metrics(served["jax"])
    assert {"serve_queue_depth", "serve_p99_ms", "serve_completed_total",
            "slo_healthy"} <= mine
    assert mine == theirs, (mine ^ theirs)


def test_remote_classifier_and_beacon(served):
    from sparknet_tpu import classify as jax_classify
    url = served["port"]
    d = classify.remote_classify(url, "lenet", _x(8))
    assert len(d["probs"]) == 10 and abs(sum(d["probs"]) - 1.0) < 1e-4
    with pytest.raises(RuntimeError, match="404"):
        classify.remote_classify(url, "nope", _x(8))
    with pytest.raises(ValueError, match="no model"):
        classify.RemoteClassifier(url, "caffenet")
    rc = classify.RemoteClassifier(url, "lenet")
    assert (rc.channels, rc.crop) == (1, 28)
    images = [np.random.default_rng(i).normal(size=(32, 32)).astype(
        np.float32) for i in (1, 2)]
    probs = rc.predict(images)
    assert probs.shape == (2, 10)
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-4)
    # the JAX client against the port's server, and the port's client
    # against the JAX shell, agree
    theirs = jax_classify.RemoteClassifier(url, "lenet").predict(images)
    np.testing.assert_allclose(probs, theirs, rtol=0, atol=PROB_TOL)
    across = classify.RemoteClassifier(served["jax"], "lenet").predict(
        images)
    np.testing.assert_allclose(probs, across, rtol=0, atol=PROB_TOL)
    # the engine beats while it serves; the endpoint file names the url
    from sparknet_tpu.parallel import health as jax_health
    beat = jax_health.read_beat(str(served["dir"] / "beats"), 0)
    assert beat is not None and beat.phase == "serving"
    assert beat.extras["serving"] and "lenet" in beat.extras["models"]
    doc = json.load(open(served["dir"] / "endpoint.json"))
    assert doc["url"] == url and doc["pid"] == served["proc"].pid


@pytest.mark.parametrize("center_only", [False, True])
def test_classify_cli_server_equals_the_local_cli(served, tmp_path,
                                                  center_only):
    batch = np.random.default_rng(9).normal(size=(3, 32, 32, 1)).astype(
        np.float32)
    np.save(tmp_path / "in.npy", batch)
    common = ["--images_dim", "32,32", "--channel_swap", "",
              "--raw_scale", "1"] + (["--center_only"] if center_only
                                     else [])
    assert classify_cli.main(
        [str(tmp_path / "in.npy"), str(tmp_path / "remote.npy"),
         "--server", served["port"], "--model", "lenet"] + common) == 0
    assert classify_cli.main(
        [str(tmp_path / "in.npy"), str(tmp_path / "local.npy"),
         "--model_def", str(served["dir"] / "deploy.prototxt"),
         "--pretrained_model", served["weights"], "--device", "cpu"]
        + common) == 0
    remote, local = (np.load(tmp_path / f"{k}.npy")
                     for k in ("remote", "local"))
    assert remote.shape == local.shape == (3, 10)
    np.testing.assert_allclose(remote, local, rtol=0, atol=PROB_TOL)
    assert (remote.argmax(1) == local.argmax(1)).all()


def test_sigterm_stops_the_server_cleanly(served):
    """Last in the module: the server answers SIGTERM with exit code 0
    and a final beat."""
    proc = served["proc"]
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == 0
    assert "shutting down" in proc.stderr.read()
    from sparknet_tpu.parallel import health as jax_health
    assert jax_health.read_beat(str(served["dir"] / "beats"),
                                0).phase == "final"


def test_parse_helpers_match_the_jax_tool():
    jserve = _jax_serve_module()
    specs = ["lenet,caffenet=w.caffemodel", " vgg16 ", "lenet@mv-1"]
    assert port_serve.parse_models(specs) == jserve.parse_models(specs)
    quotas = ["acme=200", "*=5"]
    assert port_serve.parse_quotas(quotas) == jserve.parse_quotas(quotas)
    for bad in (["acme"], ["acme=x"]):
        with pytest.raises(SystemExit):
            port_serve.parse_quotas(bad)
    for payload in ({"data": [[1, 2], [3, 4]]},
                    {"data_b64": base64.b64encode(
                        np.arange(6, dtype=np.uint8).tobytes()).decode(),
                     "dtype": "uint8", "shape": [2, 3]}):
        np.testing.assert_array_equal(port_serve.decode_array(payload),
                                      jserve.decode_array(payload))
    with pytest.raises(ValueError, match="data_b64"):
        port_serve.decode_array({})
    # the flags are the JAX tool's plus --device
    def flags(mod):
        import argparse
        seen = []
        real = argparse.ArgumentParser.parse_args

        def capture(self, argv=None, namespace=None):
            seen.extend(a.dest for a in self._actions)
            raise SystemExit(0)
        argparse.ArgumentParser.parse_args = capture
        try:
            with pytest.raises(SystemExit):
                mod.main(["--models", "lenet"])
        finally:
            argparse.ArgumentParser.parse_args = real
        return set(seen)
    assert flags(port_serve) - flags(jserve) == {"device"}
    assert flags(jserve) <= flags(port_serve)


@pytest.mark.parametrize("flag", [
    ["--fleet", "2"], ["--fleet-devices", "4"], ["--fleet-workdir", "w"],
    ["--fleet-tenant", "t"], ["--fleet-priority", "1"]],
    ids=lambda f: f[0].lstrip("-"))
def test_fleet_raises_naming_a12_and_never_serves(monkeypatch, tmp_path,
                                                  flag):
    """``--fleet`` (with each of its flags) left to its default device on
    a machine with no card raises before any replica starts: no
    endpoint, no fleet journal, and nothing carries on on the CPU."""
    import torch
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    fleet = [] if flag[0] == "--fleet" else ["--fleet", "2"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_serve.main(["--models", "lenet", *fleet, *flag,
                         "--endpoint-file", str(tmp_path / "e.json")])
    assert not (tmp_path / "e.json").exists()
    assert not list(tmp_path.rglob("fleet_journal.jsonl"))


def test_server_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.main(["--models", "lenet", "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.ModelHouse(serving.ServeConfig())
