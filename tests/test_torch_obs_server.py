"""The live telemetry endpoint (``obs/server.py``), the port against the JAX
package on the CPU: the reference's endpoint cases of
``tests/test_tracing_plane.py`` (the four routes and a 404 over real HTTP
on 127.0.0.1, scrapes counted, ``/healthz`` alive when its provider
raises), each route's body beside the reference server's for the same
state, the process-global server behind ``obs.enable`` / ``disable``, and
the serve front's ``start_obs_server``. Every ``urlopen`` has a 5 s timeout
and every server is stopped in a ``finally``.
"""
import json
import urllib.error
import urllib.request

import pytest

from edgellm_tpu import obs as jobs
from edgellm_tpu.obs import flight as jflight
from edgellm_tpu.obs.server import ObsServer as JObsServer
from edgellm_tpu_torch import obs
from edgellm_tpu_torch.obs import flight as tflight
from edgellm_tpu_torch.obs import server as tserver
from edgellm_tpu_torch.obs.server import ObsServer


def _reset_obs():
    for o, fl in ((jobs, jflight), (obs, tflight)):
        o.disable()
        o.get_registry().clear()
        o.get_tracer().clear()
        fl.configure_flight(None)


@pytest.fixture(autouse=True)
def _clean_obs():
    """Each test starts and leaves the process-global obs state clean: a
    CLI run of another test file in this worker may have left spans in the
    tracer (it restores the armed flags, not the recorded spans)."""
    _reset_obs()
    yield
    _reset_obs()


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def test_obs_server_endpoints_and_404(tmp_path):
    """All four routes over HTTP and a 404; ``/metrics`` is the registry's
    Prometheus text of that instant, ``/snapshot.json`` carries the flight
    ring, ``/trace`` the spans, and every scrape is counted."""
    obs.enable(obs.ObservabilityConfig())
    rec = tflight.FlightRecorder(str(tmp_path))
    tflight.configure_flight(rec)
    obs.get_registry().counter("serve_requests_total",
                               "terminal serve outcomes").inc(outcome="completed")
    with obs.span("serve.submit"):
        pass
    srv = ObsServer(0, health_fn=lambda: {"status": "ok", "queue_depth": 0})
    try:
        port = srv.start()
        assert srv.port == port and srv.url == f"http://127.0.0.1:{port}"
        base = f"http://127.0.0.1:{port}"
        status, ctype, body = _get(base + "/metrics")
        assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
        assert body.decode() == obs.get_registry().to_prometheus()
        assert "serve_requests_total" in body.decode()
        status, ctype, body = _get(base + "/healthz")
        assert status == 200 and ctype == "application/json"
        assert json.loads(body) == {"status": "ok", "queue_depth": 0}
        status, _, body = _get(base + "/snapshot.json")
        snap = json.loads(body)
        assert status == 200 and "serve_requests_total" in snap["metrics"]
        assert [e["name"] for e in snap["flight"]["spans"]] == ["serve.submit"]
        status, _, body = _get(base + "/trace")
        assert status == 200
        assert {e["name"] for e in json.loads(body)["traceEvents"]} == {"serve.submit"}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + "/nope")
        assert ei.value.code == 404
        assert obs.get_registry().counter("edgellm_obs_scrapes_total").value(
            endpoint="metrics") == 1.0
    finally:
        srv.stop()
    assert srv.port is None and srv.url is None


def test_healthz_survives_broken_provider():
    def broken():
        raise RuntimeError("provider exploded")

    srv = ObsServer(0, health_fn=broken)
    try:
        port = srv.start()
        status, _, body = _get(f"http://127.0.0.1:{port}/healthz")
        health = json.loads(body)
        assert status == 200 and health["status"] == "error"
        assert "provider exploded" in health["error"]
    finally:
        srv.stop()


@pytest.mark.parametrize("path", ["/metrics", "/healthz", "/snapshot.json", "/nope"])
def test_render_bodies_match_reference(path, tmp_path):
    """The same registry contents, health and flight ring (no spans) render
    the same status, content type and body in both servers."""
    outs = []
    for o, fl, cls in ((jobs, jflight, JObsServer), (obs, tflight, ObsServer)):
        o.enable(o.ObservabilityConfig(tracing=False))
        rec = fl.FlightRecorder(str(tmp_path))
        fl.configure_flight(rec)
        rec.note_request("r1", priority=1)
        reg = o.get_registry()
        reg.counter("serve_requests_total", "terminal serve outcomes").inc(outcome="completed")
        reg.gauge("serve_queue_depth", "queued requests").set(3)
        srv = cls(0, health_fn=lambda: {"status": "ok", "breakers": {"split": "closed"}})
        outs.append(srv.render(path))
        o.disable()
        fl.configure_flight(None)
    assert outs[1] == outs[0]
    assert (outs[1] is None) == (path == "/nope")


def test_global_server_follows_enable_and_disable():
    """``obs_port`` starts the process-global server on loopback (port 0: any
    free port), ``start_global`` returns the running one, ``disable`` stops
    it."""
    obs.enable(obs.ObservabilityConfig(obs_port=0))
    srv = tserver.get_global()
    try:
        assert srv is not None and srv.url.startswith("http://127.0.0.1:")
        assert tserver.start_global(0) is srv
        status, _, body = _get(srv.url + "/healthz")
        assert status == 200 and json.loads(body) == {"status": "ok"}
    finally:
        obs.disable()
    assert tserver.get_global() is None and srv.port is None


def test_serve_front_serves_its_health_and_flight_context(tmp_path):
    """``start_obs_server``: ``/healthz`` is the front's health summary and
    the armed recorder folds the front's context into a dump."""
    import torch

    from edgellm_tpu_torch.models import init_params, tiny_config
    from edgellm_tpu_torch.serve.frontend import ServeFront
    from edgellm_tpu_torch.utils.clock import FakeClock

    cfg = tiny_config("qwen2", num_layers=1, hidden_size=32, num_heads=4, vocab_size=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rec = tflight.FlightRecorder(str(tmp_path))
    tflight.configure_flight(rec)
    front = ServeFront(cfg, params, clock=FakeClock())
    try:
        port = front.start_obs_server(0)
        _, _, body = _get(f"http://127.0.0.1:{port}/healthz")
        assert json.loads(body) == json.loads(json.dumps(front.health_summary()))
    finally:
        front.stop_obs_server()
    art = tflight.load_flight(rec.dump("manual"))
    assert art["context"]["queue_depth"] == 0 and "breakers" in art["context"]
