"""Layer 3 drivers: run the REAL entry points once and verify their declared
graph contracts (the reference's ``edgellm_tpu/lint/entrypoints.py``, every
contract name it checks).

Each driver builds lint-scale inputs and calls the production function once
with the recorders of :mod:`.contracts` armed: the dispatch-mode op
recorder, the wire tap, the kernel launch counters and, on the card, torch's
sync debug mode. The reference's two-device mesh is one device here with
the stages in turn (the port's one-card :class:`~..parallel.split.Mesh`),
so the split contracts always run.

Geometry. The reference's lint model (4 layers, hidden 32, 4 heads of hd
8, vocab 128) lies outside the attention kernels' envelope
(``flash_attention.VALIDATED_HD``), so on the card every attention call
would take the plain version. The CPU keeps the reference's model, so the
tests hold each contract's numbers against the reference's; the card takes
:data:`CARD_GEOMETRY` (hd 64), at the same batch, sequence, capacity,
pages and codecs, so that K-attn, K13, K14 and the codec kernels launch.

The *declarations* live on the production code (``@graph_contract`` in
``models/transformer.py``, ``serve/decode.py``, ``models/paged_kv.py``,
``parallel/split.py``, ``codecs/faults.py``, ``codecs/fec.py``); this module
only builds inputs and the measured ``ctx`` facts (payload leaves, hop
bytes, layer counts, a link's transmissions) that parameterize them.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from .contracts import (GRAPH_CONTRACTS, check_execution, check_identity, execute)
from .report import Finding

#: example-input scale: big enough to exercise GQA + a real cut, small
#: enough that running every contract stays in seconds
BATCH, SEQ, CAPACITY = 1, 8, 16
#: paged geometry: slots, pages a slot, page size, pool pages
MS, PPS, PGS, NPG = 2, 2, 8, 5
#: the speculative verify window; the µ-batch batch and count
K_VERIFY, PBATCH, PM = 4, 2, 2
#: the faulty links' fault step: at the reference's geometry its draws fail
#: the first attempt of both links, so the executed call walks every
#: transmission the reference's statically unrolled hop carries (the port
#: retransmits only after a failed verify)
LINK_FAULT_STEP = 2

#: the reference's lint model (``tiny_config("qwen2", ...)``): hd 8
CPU_GEOMETRY = {"num_layers": 4, "hidden_size": 32, "num_heads": 4,
                "vocab_size": 128}
#: the card's: hd 64, inside the attention kernels' envelope
CARD_GEOMETRY = {"num_layers": 4, "hidden_size": 128, "num_heads": 2,
                 "vocab_size": 128}


def lint_geometry(device) -> dict:
    import torch

    return CARD_GEOMETRY if torch.device(device).type == "cuda" else CPU_GEOMETRY


def lint_model(device):
    """(cfg, params) of the lint model for ``device``, weights from seed 0."""
    import torch

    from ..models.configs import tiny_config
    from ..models.transformer import init_params

    cfg = tiny_config("qwen2", **lint_geometry(device))
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, init_params(cfg, gen, device=device)


def check_device(device: str) -> None:
    """Refuse ``--device cuda`` without a card: a CPU run is no card run."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch finds no CUDA device; pass "
                         "--device cpu to run the lint on the CPU")


def _missing(name: str) -> Finding:
    return Finding(layer="graph", rule="GC-missing", where=name, line=0,
                   message="entry point has no @graph_contract registration "
                           "(decorator removed or module not imported)")


def _driver_error(name: str, exc: Exception) -> Finding:
    return Finding(layer="graph", rule="GC-driver", where=name, line=0,
                   message=f"contract driver failed: "
                           f"{type(exc).__name__}: {exc}")


def _identity_finding(name: str, msg: str) -> Finding:
    return Finding(layer="graph", rule="GC-identity", where=name, line=0,
                   message=msg)


def _host(tokens) -> np.ndarray:
    """A token stream as a flat host array (a card tensor copied once)."""
    import torch

    if isinstance(tokens, torch.Tensor):
        tokens = tokens.detach().cpu().numpy()
    return np.asarray(tokens).reshape(-1)


def payload_info(codec, shape, device) -> Tuple[int, set, int]:
    """(leaf count, dtype names, total bytes) of one hop's wire payload,
    measured from the codec's own encode of a (shape) float32 activation."""
    import torch

    from ..codecs.wire_format import _leaves

    leaves = _leaves(codec.encode(torch.zeros(shape, device=device)))
    return (len(leaves), {str(t.dtype).removeprefix("torch.") for t in leaves},
            sum(t.numel() * t.element_size() for t in leaves))


@contextlib.contextmanager
def fused_hop_env(value: Optional[str]):
    """``EDGELLM_FUSED_HOP`` set to ``value`` (None: unset) for the block:
    the runtimes resolve their fused plans at construction."""
    saved = os.environ.get("EDGELLM_FUSED_HOP")
    try:
        if value is None:
            os.environ.pop("EDGELLM_FUSED_HOP", None)
        else:
            os.environ["EDGELLM_FUSED_HOP"] = value
        yield
    finally:
        if saved is None:
            os.environ.pop("EDGELLM_FUSED_HOP", None)
        else:
            os.environ["EDGELLM_FUSED_HOP"] = saved


def run_graph_checks(device: str = "cuda"
                     ) -> Tuple[List[Finding], List[str], List[str], dict]:
    """Run every registered graph contract against an executed call.

    Returns (findings, names of contracts verified clean, skip notes,
    per-contract detail)."""
    import torch

    # importing the production modules is what populates GRAPH_CONTRACTS
    from .. import obs
    from ..codecs.faults import FaultConfig, LinkPolicy
    from ..codecs.fec import FECConfig, HedgeConfig
    from ..models import paged_kv, transformer
    from ..parallel.split import PipelineConfig, SplitConfig, SplitRuntime
    from ..serve import batching
    from ..serve import decode as serve_decode
    from ..serve import recovery
    from ..utils import prng

    check_device(device)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    findings: List[Finding] = []
    checked: List[str] = []
    skipped: List[str] = []
    details: dict = {}
    no_sync_check: List[str] = []

    def run_one(name: str, call: Callable[[], Any], ctx=None,
                buffers: Optional[list] = None,
                outputs_of: Optional[Callable] = None) -> None:
        """``ctx``: a dict, or ``callable(execution) -> dict`` for facts
        the call itself decides (a link's transmissions)."""
        contract = GRAPH_CONTRACTS.get(name)
        if contract is None:
            findings.append(_missing(name))
            return
        try:
            mode = None
            if on_card and "host_sync" in contract.forbid:
                mode = "warn" if contract.host_syncs else "error"
            ex = execute(call, dev, sync_mode=mode)
            facts = ctx(ex) if callable(ctx) else (ctx or {})
            outs = (outputs_of(ex.result) if outputs_of is not None
                    and ex.error is None else None)
            found, detail = check_execution(contract, ex, facts, on_card=on_card,
                                            buffers=buffers, outputs=outs)
        except Exception as e:  # noqa: BLE001 — a crashed driver must be loud
            findings.append(_driver_error(name, e))
            return
        for field in ("hops", "wire_bytes"):
            want = contract.resolve(field, facts)
            if want is not None:
                detail[f"{field}_declared"] = int(want)
        details[name] = detail
        if "host_sync" in contract.forbid and not detail.get(
                "host_sync", {}).get("checked"):
            no_sync_check.append(name)
        if found:
            findings.extend(found)
        else:
            checked.append(name)

    def identity(name: str, run_a: Callable, run_b: Callable, what: str,
                 values: bool = True) -> None:
        try:
            found = check_identity(name, run_a, run_b, dev, what=what,
                                   values=values)
        except Exception as e:  # noqa: BLE001 — a crashed driver must be loud
            findings.append(_driver_error(name, e))
            return
        (findings.extend(found) if found else checked.append(name))

    def executed(name: str, body: Callable[[], Optional[str]]) -> None:
        """A value check the driver computes itself: ``body()`` returns
        None when it holds, else the finding's message."""
        try:
            msg = body()
        except Exception as e:  # noqa: BLE001 — a crashed driver must be loud
            findings.append(_driver_error(name, e))
            return
        (findings.append(_identity_finding(name, msg)) if msg
         else checked.append(name))

    cfg, params = lint_model(dev)
    layers = cfg.num_layers
    ids = torch.zeros((BATCH, SEQ), dtype=torch.long, device=dev)
    tok = torch.zeros((BATCH,), dtype=torch.long, device=dev)
    key = prng.key(0)

    def cache(batch: int = BATCH, capacity: int = CAPACITY):
        return transformer.init_cache(cfg, batch, capacity, device=dev)

    def kv_of(c) -> list:
        return [c.k, c.v]

    # ---- transformer core: prefill / decode_step (no hop, no f64, no
    # ---- host sync) -----------------------------------------------------
    run_one("transformer.prefill",
            lambda: transformer.prefill(cfg, params, ids, CAPACITY),
            {"layers": layers})
    run_one("transformer.decode_step",
            lambda: transformer.decode_step(cfg, params, cache(), tok),
            {"layers": layers})

    # ---- serve layer: generate()'s prefill and step; the step writes the
    # ---- KV cache in place -----------------------------------------------
    run_one("decode.prefill",
            lambda: serve_decode._prefill_impl(cfg, params, ids, CAPACITY, None),
            {"layers": layers})
    step_cache = cache()
    run_one("decode.step",
            lambda: serve_decode._step_impl(cfg, params, step_cache, tok, key, 0.0,
                                            None),
            {"layers": layers, "in_place_min": 2}, buffers=kv_of(step_cache),
            outputs_of=lambda r: kv_of(r[1]))

    # recovery must add NOTHING to the decode step: the LocalRuntime step is
    # the raw transformer decode_step, bit for bit
    def local_step():
        c = cache()
        return recovery.LocalRuntime(cfg).decode_step(
            params, {"k": c.k, "v": c.v, "length": c.length}, tok)

    identity("decode.recovery-identity", local_step,
             lambda: transformer.decode_step(cfg, params, cache(), tok,
                                             compute_dtype=None),
             what="LocalRuntime (recovery failover) decode step")

    # the serving front must add NOTHING either: a default-config ServeFront
    # routes admitted requests through the direct generate() loop, so the
    # decode step it runs, with the front's own bucketed capacity, is the
    # one generate runs
    from ..serve.frontend import ServeFront

    front = ServeFront(cfg, params)
    spec = front.step_trace_spec(BATCH, SEQ, max_new_tokens=CAPACITY - SEQ)
    if spec["uses_survivable_loop"]:
        findings.append(_identity_finding(
            "frontend.decode-step-identity",
            "default-config ServeFront routes decode through the survivable "
            "loop instead of the direct generate path"))
    else:
        identity("frontend.decode-step-identity",
                 lambda: serve_decode._step_impl(
                     cfg, params, cache(capacity=spec["capacity"]), tok, key,
                     spec["temperature"], spec["compute_dtype"]),
                 lambda: serve_decode._step_impl(
                     cfg, params, cache(capacity=spec["capacity"]), tok, key, 0.0,
                     None),
                 what="default-config ServeFront decode step")

    # ---- paged KV: the ragged continuous-batching step (no hop; the pool
    # ---- buffers written in place) ----------------------------------------
    def zero_pool():
        return paged_kv.init_pool(cfg, NPG, PGS, device=dev)

    ptab = torch.zeros((MS, PPS), dtype=torch.int32, device=dev)
    plens = torch.zeros((MS,), dtype=torch.int32, device=dev)
    ptoks = torch.zeros((MS,), dtype=torch.long, device=dev)
    ppool = zero_pool()
    run_one("paged.decode_step",
            lambda: paged_kv.paged_decode_step(cfg, params, ppool.k, ppool.v, ptab,
                                               plens, ptoks),
            {"layers": layers, "in_place_min": 2}, buffers=[ppool.k, ppool.v],
            outputs_of=lambda r: [r[1], r[2]])

    def bcfg(**kw):
        return batching.BatchingConfig(page_size=PGS, num_pages=NPG, max_slots=MS,
                                       pages_per_slot=PPS, **kw)

    def ref_tokens(prompt, n: int, seed: int = 0) -> np.ndarray:
        return _host(serve_decode.generate(
            cfg, params, torch.as_tensor(prompt, device=dev)[None], n,
            capacity=CAPACITY, rng_key=prng.key(seed)))

    def live_step_identity(name: str, pool, tables, what: str) -> None:
        """The ragged step over a live pool (on copies: the live state is
        not touched) runs what the step over a zero pool runs: the same
        kernels, the same ops, the same output shapes. Feature state moves
        page DATA, never the step."""
        tab, lens = tables
        live = [t.clone() for t in pool]
        zero = zero_pool()
        identity(name,
                 lambda: paged_kv.paged_decode_step(cfg, params, *live, tab, lens,
                                                    ptoks),
                 lambda: paged_kv.paged_decode_step(cfg, params, zero.k, zero.v, ptab,
                                                    plens, ptoks),
                 what=what, values=False)

    # ---- continuous batching: a single-request paged decode emits token
    # ---- for token what direct generate() emits -------------------------
    def batching_identity():
        bat = batching.ContinuousBatcher(cfg, params, bcfg())
        prompt = np.arange(1, 1 + SEQ, dtype=np.int32)
        sid = bat.submit(prompt, 6, temperature=0.0, rng_seed=0)
        got = _host(bat.run()[sid])
        ref = ref_tokens(prompt, 6)
        if not np.array_equal(got, ref):
            return (f"single-request paged decode diverged from direct "
                    f"generate: {got.tolist()} != {ref.tolist()}")
        return None

    executed("batching.decode-step-identity", batching_identity)

    # ---- prefix-sharing paged KV: the suffix prefill that backfills only
    # ---- the unmatched prompt tail (the cache written in place) ---------
    suffix_cache = cache()
    suffix_ids = torch.zeros((BATCH, 4), dtype=torch.long, device=dev)
    run_one("decode.prefill_suffix",
            lambda: serve_decode._prefill_suffix_impl(cfg, params, suffix_ids,
                                                      suffix_cache, None),
            {"layers": layers, "in_place_min": 2}, buffers=kv_of(suffix_cache),
            outputs_of=lambda r: kv_of(r[1]))

    # prefix sharing is host-side bookkeeping ONLY: a prefix-enabled batcher
    # whose pool really holds shared (refcount > 1) pages feeds the same
    # ragged step as the zero-table call
    try:
        pbat = batching.ContinuousBatcher(cfg, params, bcfg(
            prefix_cache=paged_kv.PrefixCacheConfig(enabled=True)))
        pshared = np.arange(1, 1 + PGS, dtype=np.int32)  # one full page
        pbat.submit(np.concatenate([pshared, [99]]).astype(np.int32), 4,
                    temperature=0.0, rng_seed=0)
        pbat.submit(np.concatenate([pshared, [98]]).astype(np.int32), 4,
                    temperature=0.0, rng_seed=1)
        pbat.step()  # admit both: the shared page is live under two slots
        if pbat.pool.shared_pages < 1:
            raise AssertionError("driver bug: no page ended up shared")
        live_step_identity("batching.prefix-disabled-identity", pbat.pool.pool,
                           pbat.pool.device_tables(),
                           "prefix-enabled batcher's ragged decode step")
    except Exception as e:  # noqa: BLE001 — a crashed driver must be loud
        findings.append(_driver_error("batching.prefix-disabled-identity", e))

    # ---- prefix token identity: a mixed trace (two prompts sharing a
    # ---- prefix + one disjoint, mixed temperatures) emits token for token
    # ---- what the prefix-DISABLED batcher emits ---------------------------
    def prefix_tokens():
        prng_np = np.random.default_rng(7)
        pfx = prng_np.integers(1, 128, size=PGS).astype(np.int32)
        prompts = [np.concatenate([pfx, prng_np.integers(1, 128, size=3)]),
                   np.concatenate([pfx, prng_np.integers(1, 128, size=2)]),
                   prng_np.integers(1, 128, size=6).astype(np.int32)]
        temps = [0.0, 0.8, 0.0]

        def trace(prefix_cache):
            b = batching.ContinuousBatcher(cfg, params, bcfg(prefix_cache=prefix_cache))
            sids = [b.submit(pp.astype(np.int32), 3, temperature=t, rng_seed=i)
                    for i, (pp, t) in enumerate(zip(prompts, temps))]
            out = b.run()
            b.pool.check_invariants()
            return ([_host(out[s]).tolist() for s in sids],
                    b.pool.prefix_counters)

        base, _ = trace(None)
        got, pc = trace(paged_kv.PrefixCacheConfig(enabled=True))
        if got != base:
            return (f"prefix-enabled batched decode diverged from the "
                    f"non-shared path: {got} != {base}")
        if pc["hits"] < 1 or pc["saved_tokens"] < 1:
            return (f"prefix trace never hit the index (hits={pc['hits']}, "
                    f"saved={pc['saved_tokens']}): the parity check proved "
                    f"nothing")
        return None

    executed("batching.prefix-token-identity", prefix_tokens)

    # ---- KV-at-rest quantization: the quant ragged step (no hop; all FOUR
    # ---- pool buffers, codes AND scales, written in place) --------------
    qpool = paged_kv.init_quant_pool(cfg, NPG, PGS, "int8_per_channel", device=dev)
    run_one("paged.decode_step_quant",
            lambda: paged_kv.paged_decode_step_quant(
                cfg, params, *qpool, ptab, plens, ptoks, kv_codec="int8_per_channel"),
            {"layers": layers, "in_place_min": 4}, buffers=list(qpool),
            outputs_of=lambda r: list(r[1:]))

    # the fp tier must be a NO-OP: a kv_codec="fp" batcher with live state
    # feeds the same ragged step as the pre-quantization batcher
    try:
        fbat = batching.ContinuousBatcher(cfg, params, bcfg(kv_codec="fp"))
        fbat.submit(np.arange(1, 1 + SEQ, dtype=np.int32), 4, temperature=0.0,
                    rng_seed=0)
        fbat.step()
        live_step_identity("batching.kvq-disabled-identity", fbat.pool.pool,
                           fbat.pool.device_tables(),
                           'kv_codec="fp" batcher\'s ragged decode step')
    except Exception as e:  # noqa: BLE001 — a crashed driver must be loud
        findings.append(_driver_error("batching.kvq-disabled-identity", e))

    # ---- fp-tier token identity: an explicit kv_codec="fp" batcher emits
    # ---- token for token what direct generate() emits -------------------
    def fp_tier_tokens():
        kbat = batching.ContinuousBatcher(cfg, params, bcfg(kv_codec="fp"))
        prompt = np.arange(1, 1 + SEQ, dtype=np.int32)
        sid = kbat.submit(prompt, 6, temperature=0.0, rng_seed=0)
        got = _host(kbat.run()[sid])
        ref = ref_tokens(prompt, 6)
        if not np.array_equal(got, ref):
            return (f"fp-tier paged decode diverged from direct generate: "
                    f"{got.tolist()} != {ref.tolist()}")
        return None

    executed("batching.kvq-fp-token-identity", fp_tier_tokens)

    # ---- quant decode fallback: the plain (gather) path over quantized
    # ---- pages equals quantize->dequantize + the plain fp attention
    # ---- EXACTLY, on random packed pools (the plain path runs on host
    # ---- tensors, as the wrappers take it for CPU tensors) --------------
    def quant_fallback():
        from ..models import flash_attention as fa

        rng = np.random.default_rng(3)
        kv, hd = cfg.num_kv_heads, cfg.head_dim
        rows = (NPG * PGS, kv, hd)
        for tier in ("int8_per_channel", "int4_per_channel"):
            kq, ks = fa.quantize_kv_rows(torch.from_numpy(
                rng.standard_normal(rows).astype(np.float32)), tier)
            vq, vs = fa.quantize_kv_rows(torch.from_numpy(
                rng.standard_normal(rows).astype(np.float32)), tier)
            q = torch.from_numpy(rng.standard_normal(
                (MS, 1, cfg.num_heads, hd)).astype(np.float32))
            etab = torch.from_numpy(rng.permutation(np.arange(1, NPG))[:MS * PPS]
                                    .reshape(MS, PPS).astype(np.int32))
            elens = torch.tensor([PGS + 3, PGS - 2], dtype=torch.int32)
            pages = (NPG, PGS, kv)
            got = fa.paged_decode_attention_quant(
                q, kq.reshape(pages + (-1,)), vq.reshape(pages + (-1,)),
                ks.reshape(pages), vs.reshape(pages), etab, elens, kv_codec=tier,
                plan=None)
            kf = fa.dequantize_kv_rows(kq, ks, tier).reshape(pages + (hd,))
            vf = fa.dequantize_kv_rows(vq, vs, tier).reshape(pages + (hd,))
            ref = fa.paged_decode_attention(q, kf, vf, etab, elens, plan=None)
            if not torch.equal(got, ref):
                d = float((got - ref).abs().max())
                return (f"{tier} plain fallback diverged from quantize->"
                        f"dequantize decode attention (max |d|={d:g})")
        return None

    executed("paged.quant-fallback-equivalence", quant_fallback)

    # ---- disaggregated prefill/decode: host-side orchestration. After a
    # ---- REAL migration landed (prefill on a staging worker, pages over the
    # ---- link, resume adopt) the decode batcher's ragged step is the one
    # ---- the pre-disagg batcher runs: migration moves page DATA only ----
    try:
        from ..serve import disagg as serve_disagg

        dsrv = serve_disagg.DisaggServer(
            cfg, params, bcfg(),
            serve_disagg.DisaggConfig(num_prefill_workers=1, prefill_batch=1))
        dsid = dsrv.submit(np.arange(1, 1 + SEQ, dtype=np.int32), 4,
                           temperature=0.0, rng_seed=0)
        dsrv.step()  # prefill + migrate + adopt: decode holds migrated pages
        if dsrv.report()["disagg"]["migrations"] < 1:
            raise AssertionError("driver bug: no migration happened")
        live_step_identity("disagg.disabled-identity", dsrv.pool.pool,
                           dsrv.pool.device_tables(),
                           "disagg decode batcher's ragged decode step (with "
                           "migrated pages live)")
        dsrv.run()
        dsrv.pop_result(dsid)
    except Exception as e:  # noqa: BLE001 — a crashed driver must be loud
        findings.append(_driver_error("disagg.disabled-identity", e))

    # ---- disagg migration wire bytes: every page transfer's built wire
    # ---- tree measures exactly migration_wire_nbytes(payload): the sealed
    # ---- form (payload + 8 B sidecar) and the FEC frame ------------------
    def migration_bytes():
        from ..codecs import fec as codecs_fec
        from ..codecs import wire_format as codecs_wire
        from ..serve import disagg as serve_disagg

        wbat = batching.ContinuousBatcher(cfg, params, bcfg())
        wsid = wbat.submit(np.arange(1, 1 + SEQ, dtype=np.int32), 2,
                           temperature=0.0, rng_seed=0)
        wst = wbat.prefill_hold(wsid)
        chunk = wbat.gather_rows(wst.slot, 0, PGS)
        payload = {k: torch.as_tensor(np.asarray(v)) for k, v in chunk.items()}
        sealed = codecs_wire.seal_payload(payload)
        bad = []
        measured = codecs_wire.tree_nbytes(sealed)
        declared = serve_disagg.migration_wire_nbytes(
            codecs_wire.tree_nbytes(payload), None)
        if measured != declared:
            bad.append(f"sealed frame measures {measured} B, declared {declared} B")
        fcfg = codecs_fec.FECConfig(enabled=True)
        fmeasured = codecs_wire.tree_nbytes(codecs_fec.fec_encode(sealed, fcfg))
        fdeclared = serve_disagg.migration_wire_nbytes(
            codecs_wire.tree_nbytes(payload), fcfg)
        if fmeasured != fdeclared:
            bad.append(f"FEC frame measures {fmeasured} B, declared {fdeclared} B")
        wbat.release_handoff(wsid)
        return ("migration wire-byte contract violated: " + "; ".join(bad)
                if bad else None)

    executed("disagg.migration-wire-bytes", migration_bytes)

    # ---- gray-failure hedging: host-side orchestration. A cluster whose
    # ---- gray plane REALLY fired (a hedge leg dispatched and settled first
    # ---- finisher wins) leaves every replica batcher running the same
    # ---- ragged step as the zero-table call ------------------------------
    try:
        from ..serve.cluster import ClusterConfig, ClusterFront, GrayConfig
        from ..serve.frontend import Request
        from ..serve.overload import COMPLETED
        from ..utils.clock import FakeClock

        hck = FakeClock()
        hfronts = {}

        def hedge_factory(rid, gen):
            f = ServeFront(cfg, params, clock=hck,
                           batcher=batching.ContinuousBatcher(cfg, params, bcfg()))
            hfronts[rid] = f
            return f

        hclu = ClusterFront(hedge_factory, ClusterConfig(
            num_replicas=2, probe_prefix=False,
            gray=GrayConfig(enabled=True, p95_multiple=1.5,
                            hedge_delay_quantile=0.5, min_dwell_s=0.0,
                            max_hedge_fraction=1.0, min_samples=1)),
            clock=hck)
        hprompt = np.arange(1, 1 + SEQ, dtype=np.int32)
        # two seed requests give the detector per-replica latency samples
        # (FakeClock latencies are 0, so the hedge delay collapses to 0)
        for i in range(2):
            hclu.submit(Request(prompt_ids=hprompt, max_new_tokens=3,
                                temperature=0.0, rng_seed=i))
            while hclu.drain():
                pass
        hcrid = hclu.submit(Request(prompt_ids=hprompt, max_new_tokens=3,
                                    temperature=0.0, rng_seed=7))
        hck.advance(0.5)  # older than the 0-second hedge delay
        hrecs = []
        while True:
            got = hclu.drain()
            if not got:
                break
            hrecs.extend(got)
        if hclu.totals["hedges"] < 1:
            raise AssertionError("driver bug: no hedge leg fired")
        if hclu.pending:
            raise AssertionError(f"hedge settlement lost work: {hclu.pending} pending")
        hrec = next(r for r in hrecs if r.request_id == hcrid)
        href = ref_tokens(hprompt, 3, seed=7)
        htoks = None if hrec.tokens is None else _host(hrec.tokens)
        if hrec.outcome != COMPLETED or not np.array_equal(htoks, href):
            findings.append(_identity_finding(
                "cluster.hedge-disabled-identity",
                f"hedged request diverged from direct generate: outcome="
                f"{hrec.outcome} tokens={htoks} != {href.tolist()}"))
        else:
            hpool = hfronts[0].batcher.pool
            live_step_identity("cluster.hedge-disabled-identity", hpool.pool,
                               hpool.device_tables(),
                               "gray-hedged replica's ragged decode step")
    except Exception as e:  # noqa: BLE001 — a crashed driver must be loud
        findings.append(_driver_error("cluster.hedge-disabled-identity", e))

    # ---- split pipeline: boundary hops between two stages on one device
    # ---- (the reference's 2-device mesh; the stages run in turn) ---------
    split = SplitConfig(cuts=(2,), hop_codecs=("int8_per_token",))
    devs = [dev] * split.n_stages

    def runtime(**kw):
        return SplitRuntime(cfg, split, devs, **kw)

    rt = runtime()
    placed = rt.place_params(params)
    n_hops = len(rt.codecs)
    codecs = [c.name for c in rt.codecs]
    base_ctx = {"layers": layers, "codecs": codecs, "micro": 1}

    leaves_f, dtypes_f, bytes_f = payload_info(rt.codecs[0],
                                               (BATCH, SEQ, cfg.hidden_size), dev)
    run_one("split.forward", lambda: rt.forward(placed, ids),
            {**base_ctx, "hops": n_hops * leaves_f, "wire_dtypes": frozenset(dtypes_f),
             "wire_bytes": sum(rt.hop_bytes(BATCH, SEQ))})

    def split_cache(batch: int = BATCH) -> dict:
        kv = (batch, CAPACITY, cfg.num_kv_heads, cfg.head_dim)
        return {name: [torch.zeros((stop - start,) + kv, device=dev)
                       for start, stop in rt.bounds] for name in ("k", "v")} | {
            "length": SEQ, "capacity": CAPACITY}

    def stage_kv(c: dict) -> list:
        return list(c["k"]) + list(c["v"])

    leaves_s, dtypes_s, _ = payload_info(rt.codecs[0], (BATCH, 1, cfg.hidden_size), dev)
    step_ctx = {**base_ctx, "hops": n_hops * leaves_s,
                "wire_dtypes": frozenset(dtypes_s),
                "wire_bytes": sum(rt.decode_hop_bytes(BATCH)), "in_place_min": 2}
    sc = split_cache()
    run_one("split.decode_step", lambda: rt.decode_step(placed, sc, tok), step_ctx,
            buffers=stage_kv(sc), outputs_of=lambda r: stage_kv(r[1]))

    # ---- paged split: the ragged twin of split.decode_step; every cut
    # ---- still quantizes a (max_slots, 1, D) boundary activation, the
    # ---- per-stage page pools written in place ----------------------------
    spool = rt.init_paged_pool(NPG, PGS)
    leaves_p, dtypes_p, _ = payload_info(rt.codecs[0], (MS, 1, cfg.hidden_size), dev)
    run_one("split.decode_step_paged",
            lambda: rt.decode_step_paged(placed, spool, ptab, plens, ptoks),
            {**base_ctx, "hops": n_hops * leaves_p, "wire_dtypes": frozenset(dtypes_p),
             "wire_bytes": sum(rt.decode_hop_bytes(MS)), "in_place_min": 2},
            buffers=stage_kv(spool), outputs_of=lambda r: stage_kv(r[1]))

    # ---- k-token verify: the speculative burst's ONE boundary round-trip,
    # ---- every cut quantizes a single (B, K, D) block ---------------------
    leaves_v, dtypes_v, _ = payload_info(rt.codecs[0],
                                         (BATCH, K_VERIFY, cfg.hidden_size), dev)
    vtoks = torch.zeros((BATCH, K_VERIFY), dtype=torch.long, device=dev)
    vc = split_cache()
    run_one("split.verify_step", lambda: rt.verify_step(placed, vc, vtoks),
            {**base_ctx, "hops": n_hops * leaves_v, "wire_dtypes": frozenset(dtypes_v),
             "wire_bytes": sum(rt.verify_hop_bytes(BATCH, K_VERIFY)), "in_place_min": 2},
            buffers=stage_kv(vc), outputs_of=lambda r: stage_kv(r[1]))

    # a disabled SpecConfig is host-side dispatch: a runtime that HAS run
    # verify bursts runs the same vanilla decode step as a fresh one
    rt_prespec = runtime()
    identity("split.decode_step.spec-disabled-identity",
             lambda: rt.decode_step(placed, split_cache(), tok),
             lambda: rt_prespec.decode_step(placed, split_cache(), tok),
             what="spec-aware runtime's vanilla decode step")

    # ---- micro-batch pipelined schedule: every cut moves M payloads of
    # ---- (B/M, ...): hops and wire bytes scale by M -----------------------
    rt_pipe = runtime(pipeline=PipelineConfig(num_microbatches=PM))
    pipe_ctx = {**base_ctx, "micro": PM}
    pipe_ids = torch.zeros((PBATCH, SEQ), dtype=torch.long, device=dev)
    run_one("split.forward.pipelined", lambda: rt_pipe.forward(placed, pipe_ids),
            {**pipe_ctx, "hops": PM * n_hops * leaves_f, "wire_dtypes": frozenset(dtypes_f),
             "wire_bytes": PM * sum(rt_pipe.hop_bytes(PBATCH // PM, SEQ))})
    pipe_tok = torch.zeros((PBATCH,), dtype=torch.long, device=dev)
    pc = split_cache(PBATCH)
    run_one("split.decode_step.pipelined", lambda: rt_pipe.decode_step(placed, pc, pipe_tok),
            {**pipe_ctx, "hops": PM * n_hops * leaves_s, "wire_dtypes": frozenset(dtypes_s),
             "wire_bytes": sum(rt_pipe.pipelined_decode_hop_bytes(PBATCH)),
             "in_place_min": 2},
            buffers=stage_kv(pc), outputs_of=lambda r: stage_kv(r[1]))
    # MS slots split into PM µ-batches of MS // PM ragged rows each
    ppool2 = rt_pipe.init_paged_pool(NPG, PGS)
    run_one("split.decode_step_paged.pipelined",
            lambda: rt_pipe.decode_step_paged(placed, ppool2, ptab, plens, ptoks),
            {**pipe_ctx, "hops": PM * n_hops * leaves_p, "wire_dtypes": frozenset(dtypes_p),
             "wire_bytes": sum(rt_pipe.pipelined_decode_hop_bytes(MS)), "in_place_min": 2},
            buffers=stage_kv(ppool2), outputs_of=lambda r: stage_kv(r[1]))

    # num_microbatches=1 runs the ORIGINAL sequential schedule, forward and
    # decode alike
    rt_m1 = runtime(pipeline=PipelineConfig(num_microbatches=1))
    identity("split.forward.pipeline-disabled-identity",
             lambda: rt.forward(placed, ids), lambda: rt_m1.forward(placed, ids),
             what="num_microbatches=1 build's forward")
    identity("split.decode_step.pipeline-disabled-identity",
             lambda: rt.decode_step(placed, split_cache(), tok),
             lambda: rt_m1.decode_step(placed, split_cache(), tok),
             what="num_microbatches=1 build's decode step")

    # ---- faulty link: sealed payloads, a retransmission after a failed
    # ---- verify (the reference unrolls every attempt; the port sends what
    # ---- the verify asks for, counted from the call's counters) ----------
    attempts = 2  # 1 try + 1 retry
    faults = FaultConfig(bitflip_rate=0.01, seed=0)
    rt_fault = runtime(faults=faults, policy=LinkPolicy(max_retries=attempts - 1))

    def link_ctx(link_rt, leaves: int, dtypes, frame_bytes, routes: int = 1):
        def ctx(_ex):
            c = link_rt.link_counters(reset=True)
            sent = int(np.sum(c["hops"]) + np.sum(c["retried"])) * routes
            return {**base_ctx, "transmissions": sent, "hops": leaves * sent,
                    "wire_dtypes": frozenset(dtypes), "wire_bytes": sent * frame_bytes}
        return ctx

    rt_fault.link_counters(reset=True)
    run_one("faults.hop", lambda: rt_fault.forward(placed, ids, fault_step=LINK_FAULT_STEP),
            link_ctx(rt_fault, leaves_f + 2, dtypes_f | {"uint32"}, bytes_f + 8))

    # ---- self-healing link: FEC parity + hedged routes --------------------
    fec_cfg = FECConfig(group_size=4, n_groups=4)
    hedge_cfg = HedgeConfig(routes=2)
    rt_fec = runtime(faults=faults, policy=LinkPolicy(max_retries=attempts - 1),
                     fec=fec_cfg, hedge=hedge_cfg)
    rt_fec.link_counters(reset=True)
    # 2 wire leaves a transmission: the chunk matrix + the word vector
    run_one("fec.hop", lambda: rt_fec.forward(placed, ids, fault_step=LINK_FAULT_STEP),
            link_ctx(rt_fec, 2, {"uint8", "uint32"}, fec_cfg.wire_nbytes(bytes_f + 8),
                     routes=hedge_cfg.routes))

    # a faulted build with FEC and hedging *disabled* runs the plain retry
    # hop: the same as a build that never heard of fec.py
    rt_fec_off = runtime(faults=faults, policy=LinkPolicy(max_retries=attempts - 1),
                         fec=FECConfig(enabled=False), hedge=HedgeConfig(enabled=False))
    identity("split.forward.fec-disabled-identity",
             lambda: rt_fault.forward(placed, ids, fault_step=LINK_FAULT_STEP),
             lambda: rt_fec_off.forward(placed, ids, fault_step=LINK_FAULT_STEP),
             what="disabled-FEC faulted forward")

    # ---- disabled-config identity: a zero-rate fault config and an absent
    # ---- one run the SAME call ---------------------------------------------
    rt_zero = runtime(faults=FaultConfig())
    identity("split.forward.zero-fault-identity",
             lambda: rt.forward(placed, ids), lambda: rt_zero.forward(placed, ids),
             what="zero-rate FaultConfig forward")
    identity("split.decode_step.zero-fault-identity",
             lambda: rt.decode_step(placed, split_cache(), tok),
             lambda: rt_zero.decode_step(placed, split_cache(), tok),
             what="zero-rate FaultConfig decode step")

    # ---- fused boundary hops: a forced-wire build crosses each cut as ONE
    # ---- flat sealed uint8 buffer of exactly hop_bytes + the 8-byte seal;
    # ---- a fused-DISABLED build runs the pre-fusion call ------------------
    with fused_hop_env("wire"):
        rt_fused = runtime()
    with fused_hop_env("0"):
        rt_unfused = runtime()
    with fused_hop_env(None):
        rt_default = runtime()
    if any(p is None for p in rt_fused.fused_plans):
        findings.append(Finding(
            layer="graph", rule="GC-driver", where="split.forward.fused", line=0,
            message=f"EDGELLM_FUSED_HOP=wire build refused a fused plan: "
                    f"{rt_fused.fused_plans}"))
    else:
        fused = {**base_ctx, "hops": n_hops, "wire_dtypes": frozenset({"uint8"})}
        run_one("split.forward.fused", lambda: rt_fused.forward(placed, ids),
                {**fused, "wire_bytes": sum(rt_fused.hop_bytes(BATCH, SEQ)) + 8 * n_hops})
        fc = split_cache()
        run_one("split.decode_step.fused", lambda: rt_fused.decode_step(placed, fc, tok),
                {**fused, "wire_bytes": sum(rt_fused.decode_hop_bytes(BATCH)) + 8 * n_hops,
                 "in_place_min": 2},
                buffers=stage_kv(fc), outputs_of=lambda r: stage_kv(r[1]))
        # verify-shape twin: the whole (B, K, D) burst block crosses each
        # cut as ONE flat sealed buffer, K x hop_bytes payload + the seal
        fvc = split_cache()
        run_one("split.verify_step.fused",
                lambda: rt_fused.verify_step(placed, fvc, vtoks),
                {**fused, "wire_bytes": sum(rt_fused.verify_hop_bytes(BATCH, K_VERIFY))
                 + 8 * n_hops, "in_place_min": 2},
                buffers=stage_kv(fvc), outputs_of=lambda r: stage_kv(r[1]))

    identity("split.forward.fused-disabled-identity",
             lambda: rt_default.forward(placed, ids),
             lambda: rt_unfused.forward(placed, ids),
             what="EDGELLM_FUSED_HOP=0 forward vs the pre-fusion default")
    identity("split.decode_step.fused-disabled-identity",
             lambda: rt_default.decode_step(placed, split_cache(), tok),
             lambda: rt_unfused.decode_step(placed, split_cache(), tok),
             what="EDGELLM_FUSED_HOP=0 decode step vs the pre-fusion default")

    # ---- observability identity: ARMING the obs stack (registry + tracer
    # ---- on, a span open on this thread) changes no op, no launch and no
    # ---- output bit: every instrument is host-side ------------------------
    def armed(fn: Callable) -> Callable:
        def run():
            obs.enable(obs.ObservabilityConfig())
            try:
                with obs.span("lint.obs-identity-probe"):
                    return fn()
            finally:
                obs.disable()
        return run

    identity("split.forward.obs-enabled-identity",
             lambda: rt.forward(placed, ids), armed(lambda: rt.forward(placed, ids)),
             what="obs-enabled forward")
    identity("split.decode_step.obs-enabled-identity",
             lambda: rt.decode_step(placed, split_cache(), tok),
             armed(lambda: rt.decode_step(placed, split_cache(), tok)),
             what="obs-enabled decode step")

    if no_sync_check:
        skipped.append(
            f"graph host_sync: not measured on the {dev.type} "
            f"(torch.cuda.set_sync_debug_mode needs a card) for "
            f"{len(no_sync_check)} contract(s): {', '.join(no_sync_check)}")
    if not on_card:
        skipped.append("graph launches: counted on the card only (a CPU "
                       "tensor takes every kernel's plain version)")
    return findings, checked, skipped, details


def run_moe_contract(device: str = "cuda") -> Tuple[List[Finding], dict]:
    """The ``moe.experts`` contract (no host sync, no hop, two grouped
    launches, one gather, one combine) executed over one sparse-expert
    layer of the ``tiny-lfm2`` model (hidden 128, heads of 64) at 4 x 128
    tokens, after a warm call that prepares its planes. A port-only
    contract, run beside the reference's 40 (``chip_smoke.py``'s MoE phase
    on the card) -> (findings, the contract's detail)."""
    import torch

    from ..models import moe, transformer
    from ..models.configs import PORT_PRESETS

    check_device(device)
    dev = torch.device(device)
    cfg = PORT_PRESETS["tiny-lfm2"]
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                     device=dev)
    lp = params["layers"][cfg.num_dense_layers]
    x = torch.randn((4, 128, cfg.hidden_size), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)

    def call():
        return moe.moe_ffn(cfg, lp, x, transformer.prepared_grouped_planes, transformer.linear)

    call()
    contract = GRAPH_CONTRACTS["moe.experts"]
    ex = execute(call, dev, sync_mode="error" if dev.type == "cuda" else None)
    found, detail = check_execution(contract, ex, {}, on_card=dev.type == "cuda")
    return found, detail
