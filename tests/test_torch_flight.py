"""The failure flight recorder (``obs/flight.py``), the port against the JAX
package on the CPU: the cases of the reference's
``tests/test_tracing_plane.py`` (the bounded ring and the artifact's round
trip, one dump per failure instance, no recorder no dump, corruption
refused, the watchdog's deterministic dump), each held to the reference
recorder on the same inputs.

With a ``FakeClock`` and the same notes, counters and registry contents an
artifact's bytes are the reference recorder's; spans differ only in their
timestamps and durations (each package's tracer has its own clock), which
are set aside. Each corruption (truncated header, truncated payload, bad
magic, bad version, bad CRC) is refused with the reference's message, and
each package reads the other's artifact.
"""
import struct

import numpy as np
import pytest

from edgellm_tpu import obs as jobs
from edgellm_tpu.obs import flight as jflight
from edgellm_tpu.serve import recovery as jrecovery
from edgellm_tpu.utils.clock import FakeClock as JClock
from edgellm_tpu_torch import obs
from edgellm_tpu_torch.obs import flight as tflight
from edgellm_tpu_torch.serve import recovery as trecovery
from edgellm_tpu_torch.utils.clock import FakeClock

PKGS = {"ref": (jobs, jflight, jrecovery, JClock), "port": (obs, tflight, trecovery, FakeClock)}


def _reset_obs():
    for o, fl, _, _ in PKGS.values():
        o.disable()
        o.get_registry().clear()
        o.get_tracer().clear()
        fl.configure_flight(None)


@pytest.fixture(autouse=True)
def _clean_obs():
    """Never leak armed process-global obs state across tests, and start
    clean of what another test file in this worker left behind."""
    _reset_obs()
    yield
    _reset_obs()


def _scenario(pkg, out_dir, *, registry: bool, spans: bool):
    """The reference test's ring scenario on one package -> (path, recorder)."""
    o, fl, _, clock_cls = PKGS[pkg]
    clock = clock_cls()
    rec = fl.FlightRecorder(str(out_dir), capacity=4, clock=clock)
    fl.configure_flight(rec)
    o.enable(o.ObservabilityConfig(metrics=registry, tracing=spans))
    if registry:
        o.get_registry().counter("serve_requests_total",
                                 "terminal serve outcomes").inc(outcome="completed")
    for i in range(9):  # the sink feeds the ring; the ring keeps the last 4
        with o.span("serve.execute", i=i):
            pass
    clock.advance(1.5)
    rec.note_request("r1", priority=1, prompt=8)
    rec.note_request("r2", priority=0, prompt=4)
    rec.end_request("r2")
    rec.note_counters("link", {"retried": [2], "repaired": 1})
    clock.advance(0.25)
    path = rec.dump("manual", failure=None, note="hello")
    return path, rec


def _no_times(art):
    for ev in art["spans"]:
        ev.pop("ts")
        ev.pop("dur")
    return art


@pytest.mark.parametrize("registry,spans", [(False, False), (True, False), (True, True)],
                         ids=["plain", "registry", "spans"])
def test_flight_artifact_matches_reference(tmp_path, registry, spans):
    """The ring scenario through both recorders: with no spans the two
    artifacts are byte for byte equal (the registry snapshot in them
    included); with spans equal but for the spans' times. The ring keeps
    the last four spans; the dump counts itself in the registry."""
    paths = {}
    for pkg in PKGS:
        paths[pkg], _ = _scenario(pkg, tmp_path / pkg, registry=registry, spans=spans)
        PKGS[pkg][0].disable()
    assert paths["port"].rsplit("/", 1)[1] == paths["ref"].rsplit("/", 1)[1] \
        == "flight-0001-manual.bin"
    raw = {pkg: open(p, "rb").read() for pkg, p in paths.items()}
    if not spans:
        assert raw["port"] == raw["ref"]
    art = tflight.load_flight(paths["port"])
    assert _no_times(art) == _no_times(jflight.load_flight(paths["ref"]))
    assert art["reason"] == "manual" and art["note"] == "hello" and art["t"] == 1.75
    assert art["active_requests"] == {"r1": {"priority": 1, "prompt": 8}}
    assert art["counters"] == [{"kind": "link", "delta": {"retried": [2], "repaired": 1},
                                "t": 1.5}]
    if spans:
        assert [e["args"]["i"] for e in art["spans"]] == [5, 6, 7, 8]
    if registry:
        assert obs.get_registry().counter("edgellm_flight_dumps_total").value(
            reason="manual") == 1.0


def test_flight_values_reach_the_artifact_as_plain_python(tmp_path):
    """A numpy or torch value in an extra, a note or a counter delta is
    written as the Python value the reference writes for it, never as its
    repr."""
    import torch

    rec = tflight.FlightRecorder(str(tmp_path / "port"), clock=FakeClock())
    jrec = jflight.FlightRecorder(str(tmp_path / "ref"), clock=JClock())
    rec.note_request("r1", prompt=np.int64(8), slot=torch.tensor(3))
    jrec.note_request("r1", prompt=8, slot=3)
    rec.note_counters("link", {"retried": torch.tensor([2, 0]), "repaired": np.int32(1)})
    jrec.note_counters("link", {"retried": [2, 0], "repaired": 1})
    p = rec.dump("manual", free_pages=np.int64(4), lengths=np.arange(3))
    jp = jrec.dump("manual", free_pages=4, lengths=[0, 1, 2])
    assert open(p, "rb").read() == open(jp, "rb").read()


def test_flight_dump_exactly_once_per_failure_instance(tmp_path):
    rec = tflight.FlightRecorder(str(tmp_path))
    tflight.configure_flight(rec)
    exc = trecovery.DecodeTimeout("boom")
    first = tflight.flight_dump_for(exc, where="raise_site")
    assert tflight.flight_dump_for(exc, where="catch_site") is None
    assert tflight.flight_dump_for(exc) is None
    other = tflight.flight_dump_for(trecovery.DecodeTimeout("boom 2"))
    assert rec.dumps() == [first, other]
    art = tflight.load_flight(first)
    assert art["failure"] == {"type": "DecodeTimeout", "message": "boom"}
    assert art["where"] == "raise_site"


def test_flight_dump_is_noop_without_recorder():
    assert tflight.get_flight_recorder() is None
    assert tflight.flight_dump_for(RuntimeError("nobody listening")) is None


def _corruptions(data: bytes) -> dict:
    head = struct.Struct("<8sIQI")
    magic, version, n, crc = head.unpack(data[:head.size])
    return {
        "crc": data[:-1] + bytes([data[-1] ^ 0xFF]),
        "truncated_payload": data[:-5],
        "truncated_header": data[:head.size - 3],
        "bad_magic": b"NOPE" + data[4:],
        "bad_version": head.pack(magic, 2, n, crc) + data[head.size:],
        "not_object": None,
    }


@pytest.mark.parametrize("case", ["crc", "truncated_payload", "truncated_header", "bad_magic",
                                  "bad_version", "not_object", "pristine"])
def test_flight_artifact_corruption_refused_as_reference(tmp_path, case):
    """Each damaged artifact is refused by both readers with the same
    message; a pristine one written by either package reads back in the
    other."""
    path = tflight.FlightRecorder(str(tmp_path)).dump("corruption_probe")
    data = open(path, "rb").read()
    if case == "pristine":
        jpath = jflight.FlightRecorder(str(tmp_path / "ref")).dump("corruption_probe")
        assert tflight.load_flight(jpath) == jflight.load_flight(path) == \
            tflight.load_flight(path)
        return
    bad = tmp_path / f"{case}.bin"
    if case == "not_object":
        import json
        import zlib

        payload = json.dumps([1, 2]).encode()
        bad.write_bytes(struct.pack("<8sIQI", b"EDGEFLTR", 1, len(payload),
                                    zlib.crc32(payload)) + payload)
    else:
        bad.write_bytes(_corruptions(data)[case])
    with pytest.raises(jflight.FlightArtifactError) as want:
        jflight.load_flight(str(bad))
    with pytest.raises(tflight.FlightArtifactError) as got:
        tflight.load_flight(str(bad))
    assert str(got.value) == str(want.value)


def _timeout_scenario(pkg, out_dir):
    """One injected watchdog timeout on a fake clock -> the artifact."""
    _, fl, rec_mod, clock_cls = PKGS[pkg]
    clock = clock_cls()
    rec = fl.FlightRecorder(str(out_dir), clock=clock)
    fl.configure_flight(rec)
    try:
        wd = rec_mod.Watchdog(1.0, clock=clock)
        wd.arm()
        clock.advance(2.5)
        with pytest.raises(rec_mod.DecodeTimeout) as ei:
            wd.check(what="test chunk")
        assert fl.flight_dump_for(ei.value) is None  # the raise site dumped
        (path,) = rec.dumps()
        return open(path, "rb").read(), fl.load_flight(path)
    finally:
        fl.configure_flight(None)


def test_watchdog_timeout_dumps_once_and_deterministically(tmp_path):
    """One DecodeTimeout, one artifact, bit-stable across runs and byte for
    byte the reference watchdog's."""
    a_raw, a = _timeout_scenario("port", tmp_path / "a")
    b_raw, _ = _timeout_scenario("port", tmp_path / "b")
    j_raw, _ = _timeout_scenario("ref", tmp_path / "j")
    assert a["failure"]["type"] == "DecodeTimeout" and a["what"] == "test chunk"
    assert a["deadline_s"] == 1.0 and a["elapsed_s"] == 2.5 and a["t"] == 2.5
    assert a_raw == b_raw == j_raw


def test_refused_checkpoint_load_dumps_once(tmp_path):
    """A damaged decode checkpoint is refused with one artifact carrying
    its path, as the reference's load dumps it."""
    bad = tmp_path / "broken.ckpt"
    bad.write_bytes(b"not a checkpoint at all")
    arts = {}
    for pkg in PKGS:
        _, fl, rec_mod, _ = PKGS[pkg]
        rec = fl.FlightRecorder(str(tmp_path / pkg))
        fl.configure_flight(rec)
        with pytest.raises(rec_mod.CheckpointError):
            rec_mod.DecodeCheckpoint.load(str(bad))
        (path,) = rec.dumps()
        arts[pkg] = fl.load_flight(path)
        fl.configure_flight(None)
    keep = ("reason", "failure", "path", "seq")
    assert {k: arts["port"][k] for k in keep} == {k: arts["ref"][k] for k in keep}


def test_observability_enable_arms_the_recorder(tmp_path):
    """``flight_recorder`` names the artifact directory; ``disable``
    detaches the recorder."""
    obs.enable(obs.ObservabilityConfig(flight_recorder=str(tmp_path / "fr")))
    rec = obs.get_flight_recorder()
    assert rec is not None and rec.out_dir == str(tmp_path / "fr")
    with obs.span("serve.submit"):
        pass
    assert [e["name"] for e in rec.snapshot()["spans"]] == ["serve.submit"]
    obs.disable()
    assert obs.get_flight_recorder() is None
