"""The faulty link on the port's decode paths, held against the JAX package on
the CPU: ``SplitRuntime.prefill_decode`` (keyed ``fold_in(fold_in(key(seed),
0x9EF1), fault_step)``), ``decode_step`` and ``verify_step`` (``0x57E9``, the
fill level before the write), ``decode_step_paged`` (``0x57E9``, the deepest
slot's length) and ``generate_split``'s per-call counter delta and
link-health summary.

One set of weights (the reference's ``init_params``: 6 layers, D = 32, 4
heads, V = 128) crosses with ``params_from_jax_numpy``. The link drops and
flips at rates high enough that some hops retry and some are substituted.

Tolerances: the per-hop counters and the token streams exactly (the fault
draws are the reference's threefry bits, ``utils/prng.py``); logits within
1e-3 (int8 hops: a hidden on a code boundary may move one code, as in
``tests/test_torch_split_paged.py``); an all-zero-rate config, and a link
that never corrupts, give the clean step's logits bit for bit.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgellm_tpu.codecs.faults import FaultConfig as JFaultConfig
from edgellm_tpu.codecs.faults import LinkPolicy as JLinkPolicy
from edgellm_tpu.codecs.fec import LinkHealth as JLinkHealth
from edgellm_tpu.codecs.fec import LinkHealthConfig as JLinkHealthConfig
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import tiny_config as j_tiny
from edgellm_tpu.parallel import SplitConfig as JSplitConfig
from edgellm_tpu.parallel import SplitRuntime as JSplitRuntime
from edgellm_tpu.parallel import make_stage_mesh
from edgellm_tpu.serve.decode import generate_split as j_generate_split
from edgellm_tpu.utils.clock import FakeClock as JFakeClock
from edgellm_tpu_torch.codecs.faults import FaultConfig, LinkPolicy
from edgellm_tpu_torch.codecs.fec import LinkHealth, LinkHealthConfig
from edgellm_tpu_torch.models import tiny_config as t_tiny
from edgellm_tpu_torch.models.convert import params_from_jax_numpy
from edgellm_tpu_torch.models.paged_kv import PagedKVCache
from edgellm_tpu_torch.parallel import SplitConfig, SplitRuntime
from edgellm_tpu_torch.serve.decode import generate_split
from edgellm_tpu_torch.utils import prng
from edgellm_tpu_torch.utils.clock import FakeClock

JCFG = j_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
TCFG = t_tiny("qwen2", num_layers=6, hidden_size=32, num_heads=4, vocab_size=128)
LOGIT_TOL = dict(atol=1e-3, rtol=1e-3)
#: drops and flips that make some hops retry and some exhaust their retries
FAULTS = dict(drop_rate=0.5, bitflip_rate=2e-3, seed=7)
POLICY = dict(max_retries=1)


@contextlib.contextmanager
def _separate_hops():
    saved = os.environ.get("EDGELLM_FUSED_HOP")
    os.environ["EDGELLM_FUSED_HOP"] = "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("EDGELLM_FUSED_HOP")
        else:
            os.environ["EDGELLM_FUSED_HOP"] = saved


@pytest.fixture(scope="module")
def weights():
    jp = j_init(JCFG, jax.random.key(1))
    tp = params_from_jax_numpy(TCFG, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


def _runtimes(weights, cuts, faults=FAULTS, policy=POLICY):
    jp, tp = weights
    codecs = ("int8_per_token",) * len(cuts)
    n = len(cuts) + 1
    with _separate_hops():
        jrt = JSplitRuntime(JCFG, JSplitConfig(cuts=cuts, hop_codecs=codecs),
                            make_stage_mesh(n), faults=JFaultConfig(**faults),
                            policy=JLinkPolicy(**policy))
        trt = SplitRuntime(TCFG, SplitConfig(cuts=cuts, hop_codecs=codecs), ["cpu"] * n,
                           faults=FaultConfig(**faults), policy=LinkPolicy(**policy))
    return jrt, jrt.place_params(jp), trt, trt.place_params(tp)


def _ids(seed, b, s):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(np.int32)


def _counters(rt) -> dict:
    return {k: [int(x) for x in v] for k, v in rt.link_counters().items()}


@pytest.mark.parametrize("cuts", [(2,), (1, 3)])
def test_prefill_decode_verify_counters_match_reference(weights, cuts):
    """Prefills at several fault steps, teacher-forced decode steps and a
    verify burst: every call's per-hop counters equal the reference's, and
    the logits agree (a substituted hop is zeros in both)."""
    jrt, jplaced, trt, tplaced = _runtimes(weights, cuts)
    ids = _ids(3, 2, 16)
    for fault_step in (0, 5, 11):
        want, jcache = jrt.prefill_decode(jplaced, jnp.asarray(ids[:, :6]), 16,
                                          fault_step=fault_step)
        got, tcache = trt.prefill_decode(tplaced, torch.from_numpy(ids[:, :6]).long(), 16,
                                         fault_step=fault_step)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        assert _counters(trt) == _counters(jrt)
    for t in range(6, 12):
        want, jcache = jrt.decode_step(jplaced, jcache, jnp.asarray(ids[:, t]))
        got, tcache = trt.decode_step(tplaced, tcache, torch.from_numpy(ids[:, t]).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        assert _counters(trt) == _counters(jrt), t
    want, jcache = jrt.verify_step(jplaced, jcache, jnp.asarray(ids[:, 12:16]))
    got, tcache = trt.verify_step(tplaced, tcache, torch.from_numpy(ids[:, 12:16]).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    tot = _counters(trt)
    assert tot == _counters(jrt)
    n_calls = 3 + 6 + 1
    assert tot["hops"] == [n_calls] * len(cuts)
    assert sum(tot["retried"]) > 0 and sum(tot["substituted"]) > 0
    assert tcache["length"] == 16


def test_decode_step_paged_counters_match_reference(weights):
    """Three ragged slots over four (one inactive), six steps: each step
    keyed by the deepest slot's length; counters and logits as the
    reference's."""
    jrt, jplaced, trt, tplaced = _runtimes(weights, (2,))
    host = PagedKVCache(TCFG, num_pages=16, page_size=4, max_slots=4, pages_per_slot=5,
                        device="cpu", materialize=False)
    jpool, tpool = jrt.init_paged_pool(16, 4), trt.init_paged_pool(16, 4)
    active = []
    for i, n in enumerate((5, 9, 0, 3)):
        slot = host.alloc_slot()
        if n == 0:
            continue
        prompt = _ids(10 + i, 1, n)
        _, jcache = jrt.prefill_decode(jplaced, jnp.asarray(prompt), 20)
        _, tcache = trt.prefill_decode(tplaced, torch.from_numpy(prompt).long(), 20)
        host.ensure(slot, n)
        dest = host._flat_indices(slot, n)
        jpool = jrt.adopt_paged(jpool, jcache, 0, dest, n)
        tpool = trt.adopt_paged(tpool, tcache, 0, dest, n)
        host.lengths[slot] = n
        active.append(slot)
    host.free_slot(2)
    jrt.link_counters(reset=True)
    trt.link_counters(reset=True)
    forced = _ids(4, 6, 4)
    for t in range(6):
        for slot in active:
            host.ensure(slot, int(host.lengths[slot]) + 1)
        pt, lens = host.device_tables()
        want, jpool = jrt.decode_step_paged(jplaced, jpool, jnp.asarray(pt.numpy()),
                                            jnp.asarray(lens.numpy()), jnp.asarray(forced[t]))
        got, tpool = trt.decode_step_paged(tplaced, tpool, pt, lens,
                                           torch.from_numpy(forced[t]))
        np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active], **LOGIT_TOL)
        assert _counters(trt) == _counters(jrt), t
        for slot in active:
            host.lengths[slot] += 1
    tot = _counters(trt)
    assert tot["hops"] == [6] and sum(tot["retried"]) > 0


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_split_counters_and_link_health_match_reference(weights, temperature):
    """``generate_split`` over the link with a ``fault_step`` and a
    link-health tracker: tokens, ``stats["link_counters"]`` (this call's
    delta, after an earlier call) and ``stats["link_health"]`` equal the
    reference's."""
    jrt, jplaced, trt, tplaced = _runtimes(weights, (1, 3))
    ids = _ids(8, 2, 6)
    hcfg = dict(window=2, min_dwell_s=0.0)
    jh = JLinkHealth(config=JLinkHealthConfig(**hcfg), clock=JFakeClock())
    th = LinkHealth(config=LinkHealthConfig(**hcfg), clock=FakeClock())
    for call, fault_step in enumerate((3, 9)):
        jstats, tstats = {}, {}
        want = j_generate_split(jrt, jplaced, jnp.asarray(ids), 7, capacity=16,
                                temperature=temperature, rng_key=jax.random.key(5),
                                fault_step=fault_step, stats=jstats, link_health=jh)
        got = generate_split(trt, tplaced, ids, 7, capacity=16, temperature=temperature,
                             rng_key=prng.key(5), fault_step=fault_step, stats=tstats,
                             link_health=th)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert tstats["link_counters"] == jstats["link_counters"], call
        assert tstats["link_counters"]["hops"] == [7, 7]
        assert tstats["link_health"] == jstats["link_health"]
    assert th.observations == 2


def test_zero_rate_and_clean_link_give_the_clean_logits_bit_for_bit(weights):
    """An all-zero-rate config builds no link; a link whose rates never
    fire on these calls seals, verifies and decodes each payload unchanged:
    both give the clean runtime's prefill, step and verify logits bit for
    bit, and the quiet link counts its hops with nothing detected."""
    _, tp = weights
    ids = torch.from_numpy(_ids(2, 2, 12)).long()
    outs = {}
    for name, faults in (("clean", None), ("zero", FaultConfig()),
                         ("quiet", FaultConfig(bitflip_rate=1e-12, seed=3))):
        with _separate_hops():
            rt = SplitRuntime(TCFG, SplitConfig(cuts=(1, 3), hop_codecs=("int8_per_token",) * 2),
                              ["cpu"] * 3, faults=faults)
        placed = rt.place_params(tp)
        pre, cache = rt.prefill_decode(placed, ids[:, :6], 16, fault_step=4)
        step, cache = rt.decode_step(placed, cache, ids[:, 6])
        burst, _ = rt.verify_step(placed, cache, ids[:, 7:11])
        outs[name] = (pre, step, burst, rt)
    assert outs["zero"][3].link is None and outs["quiet"][3].link is not None
    for name in ("zero", "quiet"):
        for got, want in zip(outs[name][:3], outs["clean"][:3]):
            assert torch.equal(got, want), name
    quiet = outs["quiet"][3].link_counters()
    assert list(quiet["hops"]) == [3, 3] and not quiet["detected"].any()
