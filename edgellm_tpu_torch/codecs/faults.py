"""Boundary-wire fault layer: seeded fault injection, payload integrity and
bounded-retry / degradation policies for the split pipeline's hops (PyTorch
counterpart of ``edgellm_tpu/codecs/faults.py``).

- :class:`FaultConfig`: a seeded injector spec. Bit flips hit the sealed
  payload's bytes (any leaf dtype, its little-endian byte view), scale
  corruption multiplies float leaves, a whole-hop drop zeroes the sealed
  payload, and a byte budget squeezes hops whose payload does not fit.
  Every draw comes from ``fold_in`` chains off one seed, through
  ``utils/prng.py``'s threefry, so the port corrupts the same bytes of the
  same hops as the reference, bit for bit.
- :func:`inject_faults`: one key per leaf in the reference's tree-flatten
  order (sorted dict keys: canary, crc, then the payload's leaves).
- :class:`FaultyLink`: the hop protocol under faults: encode, seal, inject,
  copy, verify, with ``LinkPolicy.max_retries`` re-sends, each with a fresh
  injection key; on exhausted retries a zero substitute or a counted
  pass-through of the corrupted decode. Where the reference unrolls every
  attempt statically, the port stops after the attempt that verified: later
  attempts draw from independent folds and change neither the counters nor
  the kept decode. Every copy sent is decoded (a corrupted one too, as the
  reference decodes it), so a hop decodes ``1 + retried`` copies (times
  the hedge's routes, :mod:`~.fec`).
- :class:`TierController`: host-side hysteresis over a codec ladder:
  consecutive corrupted chunks step the hop codecs down (int8 -> int4 ->
  ternary), consecutive clean chunks step back up.

Counters are host integers: the port runs its stages in order on the host,
so every hop is counted once, by its receiver, after a host sync of the
verify flag. With ``FaultConfig.enabled`` false the runtime builds no link
and the hop is the fault-free one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..utils import prng
from .wire_format import _leaves, _rebuild, seal_payload, tree_nbytes, verify_payload

#: per-hop counter names accumulated by :class:`FaultyLink` (receiver-side):
#: hops = transfers attempted, detected = corrupted arrivals caught by the
#: integrity check, retried = re-sends actually needed, recovered = hops that
#: failed at least once but eventually verified, substituted = hops that
#: exhausted retries and fell back per the policy, budget_dropped = hops whose
#: packed payload exceeded the byte budget. A self-healing link
#: (:mod:`~.fec`) appends "repaired" and "hedge_wins".
COUNTER_KEYS = ("hops", "detected", "retried", "recovered", "substituted",
                "budget_dropped")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded wire-fault rates. All rates are per *attempt*; ``bitflip_rate``
    is per payload byte, ``scale_corrupt_rate`` per float element,
    ``drop_rate`` per hop. ``byte_budget`` (bytes) squeezes any hop whose
    packed payload exceeds it. ``enabled`` False builds no link."""

    bitflip_rate: float = 0.0
    scale_corrupt_rate: float = 0.0
    drop_rate: float = 0.0
    byte_budget: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        for f in ("bitflip_rate", "scale_corrupt_rate", "drop_rate"):
            v = getattr(self, f)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"{f} must be a number, got {v!r}")
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        if self.byte_budget is not None and (
                isinstance(self.byte_budget, bool)
                or not isinstance(self.byte_budget, int)
                or self.byte_budget <= 0):
            raise ValueError(f"byte_budget must be a positive integer, "
                             f"got {self.byte_budget!r}")
        if isinstance(self.seed, bool) or not isinstance(self.seed, int):
            raise ValueError(f"seed must be an integer, got {self.seed!r}")

    @property
    def enabled(self) -> bool:
        return (self.bitflip_rate > 0 or self.scale_corrupt_rate > 0
                or self.drop_rate > 0 or self.byte_budget is not None)


@dataclasses.dataclass(frozen=True)
class LinkPolicy:
    """What the receiver does about a hop that fails integrity.

    ``max_retries`` re-sends, each with a fresh injection key. When all
    attempts fail: ``on_fail="substitute"`` forwards a zero hidden state and
    counts the hop as degraded; ``on_fail="passthrough"`` decodes the
    corrupted payload anyway (counted). ``tiers`` names the codec ladder
    :class:`TierController` walks; ``degrade_after`` / ``recover_after`` are
    its thresholds in consecutive chunks."""

    max_retries: int = 0
    on_fail: str = "substitute"
    tiers: tuple = ()
    degrade_after: int = 2
    recover_after: int = 8

    def __post_init__(self):
        if self.on_fail not in ("substitute", "passthrough"):
            raise ValueError(f"on_fail must be 'substitute' or 'passthrough', "
                             f"got {self.on_fail!r}")
        for f, lo in (("max_retries", 0), ("degrade_after", 1),
                      ("recover_after", 1)):
            v = getattr(self, f)
            if isinstance(v, bool) or not isinstance(v, int) or v < lo:
                raise ValueError(f"{f} must be an integer >= {lo}, got {v!r}")


def fault_key(seed: int, step: int) -> torch.Tensor:
    """The per-call fault key, ``fold_in(key(seed), step)``, as (1, 2) words."""
    return fold(torch.tensor([prng.key(seed)], dtype=torch.int64), step)


def fold(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` of one (1, 2) key by a non-negative int."""
    return prng.fold_in(key, torch.tensor([int(data)], dtype=torch.int64, device=key.device))


def _leaf_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).contiguous().view(torch.uint8)


def inject_faults(sealed: dict, key: torch.Tensor, cfg: FaultConfig) -> dict:
    """Corrupt a sealed payload tree per ``cfg``, deterministically from the
    (1, 2) ``key``. Bit flips and drops hit every leaf (a flipped checksum is
    a detected corruption too); scale corruption hits float leaves. A zero
    rate draws nothing; an untouched leaf is returned as it is."""
    leaves = _leaves(sealed)
    drop = (bool(prng.bernoulli(fold(key, 0xD0), cfg.drop_rate, 1)[0, 0])
            if cfg.drop_rate > 0 else False)
    out = []
    for j, x in enumerate(leaves):
        kj = fold(key, j)
        if cfg.bitflip_rate > 0 and x.numel():
            b = _leaf_bytes(x).clone()
            n = b.numel()
            k_hit, k_bit = prng.split(kj.to(x.device))[0]
            hit = prng.bernoulli(k_hit[None], cfg.bitflip_rate, n)[0]
            bit = prng.randint(k_bit[None], n, 0, 8)[0]
            b ^= torch.where(hit, 1 << bit, 0).to(torch.uint8)
            x = b.view(x.dtype).reshape(x.shape)
        if cfg.scale_corrupt_rate > 0 and x.numel() and x.is_floating_point():
            k_sc = fold(kj, 0x5C).to(x.device)
            hit = prng.bernoulli(k_sc, cfg.scale_corrupt_rate, x.numel())[0].reshape(x.shape)
            # affine blowup in the leaf's dtype: moves every value, zeros too
            blown = (x * torch.tensor(-997.0, dtype=x.dtype, device=x.device)
                     + torch.tensor(1.0, dtype=x.dtype, device=x.device))
            x = torch.where(hit, blown, x)
        if drop:
            x = torch.zeros(x.numel() * x.element_size(), dtype=torch.uint8,
                            device=x.device).view(x.dtype).reshape(x.shape)
        out.append(x)
    return _rebuild(sealed, iter(out))


def transport(tree: dict, dst) -> dict:
    """Every leaf of a wire tree copied to ``dst`` (a real copy, never an
    alias): the crossing of the cut."""
    if isinstance(tree, dict):
        return {k: transport(v, dst) for k, v in tree.items()}
    return tree.to(dst, copy=True)


def encode_hop(codec, hidden: torch.Tensor, hop_imp):
    if codec.needs_importance:
        return codec.encode(hidden, hop_imp)
    return codec.encode(hidden)


def finish_hop(policy: LinkPolicy, hidden: torch.Tensor, ok: bool, decoded, last_dec,
               dst) -> torch.Tensor:
    """The hop's delivered hidden: the verified decode, else per the policy a
    zero substitute or the last corrupted decode, in the dtype the
    reference's select gives (the decode's float32 promoted with the
    hidden's)."""
    dtype = torch.promote_types(last_dec.dtype, hidden.dtype)
    if ok:
        return decoded.to(dtype)
    if policy.on_fail == "substitute":
        return torch.zeros(hidden.shape, dtype=dtype, device=dst)
    return last_dec.to(dtype)


@dataclasses.dataclass(frozen=True)
class FaultyLink:
    """The hop protocol under faults, which the pipeline calls in place of
    the bare encode / copy / decode when faults are on.

    ``fec`` (a :class:`~.fec.FECConfig`) and ``hedge`` (a
    :class:`~.fec.HedgeConfig`) arm the self-healing ladder; with both
    absent or disabled, :meth:`hop` is the plain retry protocol."""

    faults: FaultConfig
    policy: LinkPolicy
    fec: Optional[Any] = None
    hedge: Optional[Any] = None

    @property
    def healing(self) -> bool:
        return ((self.fec is not None and self.fec.enabled)
                or (self.hedge is not None and self.hedge.enabled))

    @property
    def counter_keys(self) -> tuple:
        keys = COUNTER_KEYS
        if self.fec is not None and self.fec.enabled:
            keys = keys + ("repaired",)
        if self.hedge is not None and self.hedge.enabled:
            keys = keys + ("hedge_wins",)
        return keys

    def init_counters(self, n_hops: int) -> dict:
        return {k: np.zeros((n_hops,), np.int64) for k in self.counter_keys}

    def hop(self, codec: Any, hidden: torch.Tensor, s: int, dst, key: torch.Tensor,
            counters: dict, hop_imp: Optional[torch.Tensor] = None) -> tuple:
        """One faulty crossing of cut ``s`` to device ``dst``: encode once,
        then up to 1 + max_retries sealed transmissions, each with its own
        injection key ``fold_in(fold_in(key, s), attempt)``; ``counters``
        (this call's, per hop) are bumped in place. Returns the delivered
        hidden."""
        if self.healing:
            from .fec import healing_hop

            return healing_hop(self, codec, hidden, s, dst, key, counters, hop_imp)
        payload = encode_hop(codec, hidden, hop_imp)
        over_budget = (self.faults.byte_budget is not None
                       and tree_nbytes(payload) > self.faults.byte_budget)
        sealed = seal_payload(payload)
        k_hop = fold(key, s)
        counters["hops"][s] += 1
        if over_budget:
            counters["budget_dropped"][s] += 1
        ok, first_fail, decoded, last_dec = False, False, None, None
        for a in range(1 + self.policy.max_retries):
            moved = transport(inject_faults(sealed, fold(k_hop, a), self.faults), dst)
            # the squeezed link never delivers; the verify is the authority
            ok_a = not over_budget and bool(verify_payload(moved))
            last_dec = codec.decode(moved["p"])
            if ok_a:
                decoded = last_dec
            else:
                counters["detected"][s] += 1
            if a > 0:
                counters["retried"][s] += 1
            if a == 0:
                first_fail = not ok_a
            if ok_a:
                ok = True
                break
        counters["recovered"][s] += int(ok and first_fail)
        counters["substituted"][s] += int(not ok)
        return finish_hop(self.policy, hidden, ok, decoded, last_dec, dst)


class TierController:
    """Host-side hysteresis over a codec degradation ladder.

    ``observe(corrupted)`` once per evaluation chunk: ``degrade_after``
    consecutive corrupted chunks step to the next (lower-precision) tier,
    ``recover_after`` consecutive clean chunks step back up. Both streaks
    reset on a switch."""

    def __init__(self, n_tiers: int, degrade_after: int = 2, recover_after: int = 8):
        if n_tiers < 1:
            raise ValueError("need at least one tier")
        self.n_tiers = n_tiers
        self.degrade_after = degrade_after
        self.recover_after = recover_after
        self.tier = 0
        self.switches = 0
        self._bad = 0
        self._good = 0

    def observe(self, corrupted: bool) -> int:
        if corrupted:
            self._bad += 1
            self._good = 0
            if self._bad >= self.degrade_after and self.tier < self.n_tiers - 1:
                self.tier += 1
                self.switches += 1
                self._bad = 0
        else:
            self._good += 1
            self._bad = 0
            if self._good >= self.recover_after and self.tier > 0:
                self.tier -= 1
                self.switches += 1
                self._good = 0
        return self.tier


def sum_counters(counter_list: Optional[Sequence[dict]]) -> Optional[dict]:
    """Host-side total of per-call counter dicts -> {key: (n_hops,) int64
    ndarray}. None/empty in, None out."""
    if not counter_list:
        return None
    tot = {k: np.zeros_like(np.asarray(counter_list[0][k]), dtype=np.int64)
           for k in counter_list[0]}
    for c in counter_list:
        for k, v in c.items():
            tot[k] = tot[k] + np.asarray(v, dtype=np.int64)
    return tot


def flatten_counters(counters: Optional[dict]) -> dict:
    """Collapse a per-hop counter dict ({key: (n_hops,) ints}) to per-key
    scalar totals: {key: int}. None/empty in, {} out."""
    if not counters:
        return {}
    return {k: int(np.asarray(v, dtype=np.int64).sum()) for k, v in counters.items()}


__all__ = ["COUNTER_KEYS", "FaultConfig", "LinkPolicy", "fault_key", "inject_faults",
           "FaultyLink", "TierController", "sum_counters", "flatten_counters"]
