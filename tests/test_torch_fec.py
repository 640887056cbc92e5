"""The port's self-healing link (``codecs/fec.py``) against the TPU
package's, on the CPU.

- ``fec_encode``: the chunk matrix and the checksum words equal the
  reference's byte for byte, over several parity layouts;
- ``fec_decode``: on the same damage (the same injected faults) it flags
  and repairs the same chunks, gives the same seal verdict and the same
  reconstructed bytes;
- ``LinkHealth``: one counter stream on a fake clock gives the same tier
  trail and ``summary()``;
- the configs refuse what the reference refuses.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgellm_tpu.codecs import faults as jf
from edgellm_tpu.codecs import fec as jfec
from edgellm_tpu.utils.clock import FakeClock as JFakeClock
from edgellm_tpu_torch.codecs import faults as tf
from edgellm_tpu_torch.codecs import fec as tfec
from edgellm_tpu_torch.codecs import wire_format as twf
from edgellm_tpu_torch.utils.clock import FakeClock


@pytest.fixture(scope="module")
def sealed():
    rng = np.random.default_rng(0)
    raw = {"q": rng.integers(-128, 128, (2, 16, 48)).astype(np.int8),
           "scale": rng.random((2, 16, 1)).astype(np.float32),
           "mn": rng.normal(size=(2, 16, 1)).astype(np.float32)}
    return (jf.seal_payload({k: jnp.asarray(v) for k, v in raw.items()}),
            twf.seal_payload({k: torch.from_numpy(v) for k, v in raw.items()}))


LAYOUTS = [(4, 4), (2, 3), (1, 1), (5, 2), (3, 7)]


@pytest.mark.parametrize("gs,ng", LAYOUTS)
def test_fec_encode_bytes_equal(sealed, gs, ng):
    js, ts = sealed
    want = jfec.fec_encode(js, jfec.FECConfig(group_size=gs, n_groups=ng))
    got = tfec.fec_encode(ts, tfec.FECConfig(group_size=gs, n_groups=ng))
    np.testing.assert_array_equal(got["chunks"].numpy(), np.asarray(want["chunks"]))
    assert got["words"].dtype == torch.uint32
    np.testing.assert_array_equal(twf._from_u32(got["words"]).numpy(),
                                  np.asarray(want["words"]).astype(np.int64))
    cfg = tfec.FECConfig(group_size=gs, n_groups=ng)
    n = twf.tree_nbytes(ts)
    assert cfg.wire_nbytes(n) == twf.tree_nbytes(got) == jfec.FECConfig(
        group_size=gs, n_groups=ng).wire_nbytes(n)
    assert cfg.overhead(n) == jfec.FECConfig(group_size=gs, n_groups=ng).overhead(n)


@pytest.mark.parametrize("gs,ng", LAYOUTS[:2])
@pytest.mark.parametrize("rates", [dict(bitflip_rate=3e-3), dict(bitflip_rate=2e-4),
                                   dict(drop_rate=0.4, bitflip_rate=1e-3)])
def test_fec_decode_repairs_the_same_chunks(sealed, gs, ng, rates):
    js, ts = sealed
    jc, tc = jfec.FECConfig(group_size=gs, n_groups=ng), tfec.FECConfig(group_size=gs,
                                                                        n_groups=ng)
    jw, tw = jfec.fec_encode(js, jc), tfec.fec_encode(ts, tc)
    damage = jax.jit(lambda w, k: jfec.fec_decode(
        jf.inject_faults(w, k, jf.FaultConfig(**rates, seed=2)), jc, js))
    verdicts = set()
    for step in range(8):
        to = tf.inject_faults(tw, tf.fault_key(2, step), tf.FaultConfig(**rates, seed=2))
        ja, jbad, jrep = damage(jw, jax.random.fold_in(jax.random.key(2), step))
        ta, tbad, trep = tfec.fec_decode(to, tc, ts)
        assert (tbad, trep) == (bool(jbad), bool(jrep))
        ok = bool(twf.verify_payload(ta))
        assert ok == bool(jf.verify_payload(ja))
        for a, b in zip(jax.tree_util.tree_leaves(ja), twf._leaves(ta)):
            np.testing.assert_array_equal(b.contiguous().view(torch.uint8).numpy().reshape(-1),
                                          np.asarray(a).view(np.uint8).reshape(-1))
        verdicts.add((tbad, trep, ok))
    assert any(bad for bad, _, _ in verdicts)  # the rates do damage chunks


def test_clean_wire_decodes_to_the_sealed_payload(sealed):
    _, ts = sealed
    cfg = tfec.FECConfig()
    arrived, bad, repaired = tfec.fec_decode(tfec.fec_encode(ts, cfg), cfg, ts)
    assert (bad, repaired) == (False, False) and bool(twf.verify_payload(arrived))
    for a, b in zip(twf._leaves(arrived), twf._leaves(ts)):
        assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("cfg", [
    dict(window=4, error_budget=0.05, min_dwell_s=0.0),
    dict(window=3, error_budget=0.2, degrade_burn=1.0, promote_burn=0.5, min_dwell_s=2.0),
    dict(window=1, error_budget=0.5)])
def test_link_health_summary_and_tier_follow_reference(cfg):
    rng = np.random.default_rng(len(cfg))
    jclock, tclock = JFakeClock(), FakeClock()
    j = jfec.LinkHealth(3, jfec.LinkHealthConfig(**cfg), clock=jclock)
    t = tfec.LinkHealth(3, tfec.LinkHealthConfig(**cfg), clock=tclock)
    tiers = []
    for i in range(60):
        phase = 0.9 if i < 20 else (0.0 if i < 45 else 0.5)
        hops = 4
        detected = int((rng.random(hops) < phase).sum())
        delta = {"hops": [hops], "detected": [detected],
                 "repaired": [int(rng.integers(0, detected + 1))],
                 "retried": [int(rng.integers(0, 3))], "substituted": [0],
                 "hedge_wins": [int(rng.integers(0, 2))]}
        if i % 7 == 3:
            delta = None  # a chunk with no counters observes cleanly
        jclock.advance(0.7)
        tclock.advance(0.7)
        tiers.append((j.observe(delta), t.observe(delta)))
        assert t.summary() == j.summary()
    assert all(a == b for a, b in tiers)
    assert t.switches >= 1
    assert (t.corruption_rate, t.repair_rate, t.retry_rate, t.hedge_win_rate, t.burn_rate) == (
        j.corruption_rate, j.repair_rate, j.retry_rate, j.hedge_win_rate, j.burn_rate)


BAD = [("FECConfig", dict(group_size=0)), ("FECConfig", dict(enabled=1)),
       ("FECConfig", dict(n_groups=2.0)), ("HedgeConfig", dict(routes=1)),
       ("HedgeConfig", dict(enabled="yes")), ("LinkHealthConfig", dict(window=0)),
       ("LinkHealthConfig", dict(error_budget=0.0)),
       ("LinkHealthConfig", dict(promote_burn=1.0, degrade_burn=1.0)),
       ("LinkHealthConfig", dict(min_dwell_s=-1.0))]


@pytest.mark.parametrize("cls,kw", BAD, ids=range(len(BAD)))
def test_fec_config_validation_matches_reference(cls, kw):
    with pytest.raises(ValueError) as want:
        getattr(jfec, cls)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(tfec, cls)(**kw)
    assert str(got.value) == str(want.value)
