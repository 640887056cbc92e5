"""The port's fault layer (``codecs/faults.py``) and its PRNG pieces against
the TPU package's, on the CPU.

- ``inject_faults``: the same sealed payload and the same key give the same
  bytes, over every leaf dtype the codecs seal (int8, uint8, float32,
  bfloat16), for bit flips, scale corruption and drops, alone and together
  (exact: the counters downstream depend on nothing else);
- ``prng.split`` / ``bernoulli`` / ``randint``: JAX's bits, exactly;
- ``TierController``: the same observe sequences reach the same tiers;
- ``FaultConfig`` / ``LinkPolicy``: the port refuses what the reference
  refuses, with its messages;
- ``FaultyLink.hop``: one hop's counters and delivered hidden on a 2-stage
  split equal the reference's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgellm_tpu.codecs import faults as jf
from edgellm_tpu_torch.codecs import faults as tf
from edgellm_tpu_torch.codecs import wire_format as twf
from edgellm_tpu_torch.utils import prng


def _key_words(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(np.int64))[None]


def _payloads(seed=0):
    """A sealed tree with a leaf of every dtype the codecs seal."""
    rng = np.random.default_rng(seed)
    raw = {"q": rng.integers(-128, 128, (2, 16, 32)).astype(np.int8),
           "packed": rng.integers(0, 256, (2, 16, 8)).astype(np.uint8),
           "scale": rng.random((2, 16, 1)).astype(np.float32) + 0.5,
           "hi": rng.normal(size=(2, 4, 32)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in raw.items()}
    jp["hi"] = jp["hi"].astype(jnp.bfloat16)
    tp = {k: torch.from_numpy(v) for k, v in raw.items()}
    tp["hi"] = tp["hi"].bfloat16()
    return jf.seal_payload(jp), twf.seal_payload(tp)


def _bytes_j(x) -> np.ndarray:
    a = np.asarray(x)
    return (a.view(np.uint16) if a.dtype == jnp.bfloat16 else a).view(np.uint8).reshape(-1)


def _bytes_t(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.uint8).numpy().reshape(-1)


@pytest.fixture(scope="module")
def sealed():
    return _payloads()


FAULTS = [dict(bitflip_rate=0.05), dict(scale_corrupt_rate=0.3), dict(drop_rate=0.5),
          dict(bitflip_rate=0.01, scale_corrupt_rate=0.2, drop_rate=0.3)]


@pytest.mark.parametrize("cfg", FAULTS, ids=["flips", "scale", "drop", "all"])
def test_inject_faults_equals_reference_byte_for_byte(sealed, cfg):
    js, ts = sealed
    jc, tc = jf.FaultConfig(**cfg, seed=3), tf.FaultConfig(**cfg, seed=3)
    inject = jax.jit(lambda s, k: jf.inject_faults(s, k, jc))
    touched = 0
    for step in range(4):
        want = inject(js, jax.random.fold_in(jax.random.key(3), step))
        got = tf.inject_faults(ts, tf.fault_key(3, step), tc)
        for w, g in zip(jax.tree_util.tree_leaves(want), twf._leaves(got)):
            assert g.dtype == {"int8": torch.int8, "uint8": torch.uint8, "uint32": torch.uint32,
                               "float32": torch.float32,
                               "bfloat16": torch.bfloat16}[str(np.asarray(w).dtype)]
            np.testing.assert_array_equal(_bytes_t(g), _bytes_j(w))
        touched += sum(int((_bytes_t(a) != _bytes_t(b)).any())
                       for a, b in zip(twf._leaves(got), twf._leaves(ts)))
        assert bool(twf.verify_payload(got)) == bool(jf.verify_payload(want))
    assert touched  # the rates do fire at this size


def test_zero_rates_leave_the_payload_untouched(sealed):
    _, ts = sealed
    got = tf.inject_faults(ts, tf.fault_key(0, 1), tf.FaultConfig())
    assert all(a is b for a, b in zip(twf._leaves(got), twf._leaves(ts)))


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3), (123456, 2 ** 20 + 5)])
def test_prng_split_bernoulli_randint_equal_jax(seed, step):
    key = jax.random.fold_in(jax.random.key(seed), step)
    words = _key_words(key)
    np.testing.assert_array_equal(
        prng.split(words)[0].numpy(),
        np.asarray(jax.random.key_data(jax.random.split(key))).astype(np.int64))
    np.testing.assert_array_equal(
        prng.split(words, 5)[0].numpy(),
        np.asarray(jax.random.key_data(jax.random.split(key, 5))).astype(np.int64))
    for p in (0.0, 2e-5, 0.05, 0.5, 1.0):
        want = np.asarray(jax.random.bernoulli(key, p, (3, 41))).reshape(-1)
        np.testing.assert_array_equal(prng.bernoulli(words, p, 123)[0].numpy(), want)
    for lo, hi in ((0, 8), (0, 3), (-5, 11), (0, 70000), (0, 2 ** 31 - 1), (10, 10), (4, 2)):
        want = np.asarray(jax.random.randint(key, (57,), lo, hi))
        np.testing.assert_array_equal(prng.randint(words, 57, lo, hi)[0].numpy(), want)
    assert tuple(tf.fault_key(seed, step)[0].tolist()) == tuple(words[0].tolist())


@pytest.mark.parametrize("n_tiers,degrade,recover", [(3, 2, 8), (3, 1, 2), (2, 3, 1), (1, 1, 1)])
def test_tier_controller_follows_reference(n_tiers, degrade, recover):
    seq = np.random.default_rng(n_tiers * 10 + degrade).random(200) < 0.55
    seq[:6] = True
    seq[60:80] = False
    j, t = jf.TierController(n_tiers, degrade, recover), tf.TierController(n_tiers, degrade,
                                                                        recover)
    trail = [(j.observe(bool(c)), t.observe(bool(c))) for c in seq]
    assert all(a == b for a, b in trail)
    assert (j.tier, j.switches) == (t.tier, t.switches)
    if n_tiers > 1:
        assert t.switches >= 2


BAD_FAULTS = [dict(bitflip_rate=1.5), dict(drop_rate=-0.1), dict(scale_corrupt_rate="x"),
              dict(bitflip_rate=True), dict(byte_budget=0), dict(byte_budget=1.5),
              dict(byte_budget=True), dict(seed=1.0), dict(seed=False)]
BAD_POLICY = [dict(on_fail="retry"), dict(max_retries=-1), dict(max_retries=1.0),
              dict(degrade_after=0), dict(recover_after=True)]


@pytest.mark.parametrize("kw", BAD_FAULTS + BAD_POLICY, ids=range(len(BAD_FAULTS + BAD_POLICY)))
def test_config_validation_refuses_what_reference_refuses(kw):
    is_policy = kw in BAD_POLICY
    with pytest.raises(ValueError) as want:
        (jf.LinkPolicy if is_policy else jf.FaultConfig)(**kw)
    with pytest.raises(ValueError) as got:
        (tf.LinkPolicy if is_policy else tf.FaultConfig)(**kw)
    assert str(got.value) == str(want.value)


def test_enabled_and_counter_helpers():
    assert not tf.FaultConfig().enabled and not tf.FaultConfig(seed=4).enabled
    assert tf.FaultConfig(byte_budget=10).enabled and tf.FaultConfig(drop_rate=0.1).enabled
    c = [{"hops": np.array([1, 2]), "detected": np.array([0, 1])},
         {"hops": np.array([3, 0]), "detected": np.array([1, 1])}]
    for k, v in tf.sum_counters(c).items():
        np.testing.assert_array_equal(v, jf.sum_counters(c)[k])
    assert tf.flatten_counters(tf.sum_counters(c)) == jf.flatten_counters(jf.sum_counters(c))
    assert tf.sum_counters([]) is None and tf.flatten_counters(None) == {}
    assert tf.COUNTER_KEYS == jf.COUNTER_KEYS


@pytest.mark.parametrize("policy", [dict(max_retries=2), dict(max_retries=0, on_fail="passthrough")])
def test_faulty_link_hop_matches_reference(policy):
    """One faulty int8_per_token hop on a 2-stage split, several fault
    steps: the reference's counters and delivered hidden."""
    from edgellm_tpu.codecs.packing import get_wire_codec as jcodec
    from edgellm_tpu.parallel import make_stage_mesh
    from edgellm_tpu.parallel.split import run_pipeline_stages as jrun
    from edgellm_tpu.utils.jax_compat import shard_map
    from jax.sharding import PartitionSpec as P
    from edgellm_tpu_torch.codecs.packing import get_wire_codec

    faults = dict(bitflip_rate=3e-4, drop_rate=0.3, seed=5)
    jl = jf.FaultyLink(jf.FaultConfig(**faults), jf.LinkPolicy(**policy))
    tl = tf.FaultyLink(tf.FaultConfig(**faults), tf.LinkPolicy(**policy))
    h = np.random.default_rng(1).normal(size=(2, 16, 64)).astype(np.float32)
    mesh = make_stage_mesh(2)

    def body(x, step):
        key = jax.random.fold_in(jax.random.key(5), step)
        return jrun(2, [jcodec("int8_per_token")], lambda y: y, x, link=jl, fault_key=key)

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                           check_vma=False))
    for step in range(8):
        want, wc = fn(jnp.asarray(h), jnp.int32(step))
        counters = tl.init_counters(1)
        got = tl.hop(get_wire_codec("int8_per_token"), torch.from_numpy(h), 0, "cpu",
                     tf.fault_key(5, step), counters)
        assert {k: int(v[0]) for k, v in counters.items()} == \
            {k: int(np.asarray(v)[0]) for k, v in wc.items()}
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
