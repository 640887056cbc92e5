"""Self-healing boundary links: in-band FEC repair, hedged hops and a
host-side link-health SLO controller over the faulty split wire (PyTorch
counterpart of ``edgellm_tpu/codecs/fec.py``).

- :class:`FECConfig` + :func:`fec_encode` / :func:`fec_decode`: the sealed
  payload's byte stream is interleaved round-robin into ``group_size *
  n_groups`` data chunks; chunk ``c`` joins parity group ``c % n_groups``.
  Every group carries one XOR parity chunk, and every chunk (parity too) a
  canary-folded weighted-byte checksum word, so a single corrupted byte in a
  chunk always trips its word. A group with exactly one bad data chunk and a
  good parity chunk is repaired by ``parity ^ xor(group)``; more damage is
  left to the retry ladder, the outer seal staying the authority. The wire
  bytes equal the reference's.
- :func:`healing_hop`: detect -> repair -> retry -> hedge -> substitute.
  With :class:`HedgeConfig` every attempt sends ``routes`` copies, each with
  an independent injection key, and keeps the first verified one. The port
  sends every route of an attempt (the hedge's wire cost) and stops after
  the attempt that verified, so a hop sends and decodes ``routes x (1 +
  retried)`` copies.
- :class:`LinkHealth`: the SLO half, a sibling of
  :class:`~.faults.TierController` over windowed corruption / repair /
  retry / hedge-win rates, which degrades the codec tier while the error
  budget burns and re-promotes once it recovers, with a full-window
  re-measure and a clock dwell between switches. Each observation
  publishes :meth:`LinkHealth.summary` into the global obs registry when
  it is enabled; ``--fault-report`` reads the summary too.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from ..utils.clock import MONOTONIC, Clock
from ..lint import graph_contract
from ..lint.contracts import hop_launches
from .faults import encode_hop, finish_hop, fold, inject_faults, transport
from .wire_format import (_CRC_MULT, _MASK, _as_u32, _from_u32, _mulmod, flatten_bytes,
                          seal_payload, tree_nbytes, unflatten_bytes, verify_payload)

#: folded into every chunk checksum word so an all-zero (dropped) chunk and
#: its zeroed word can never agree
_CHUNK_CANARY = 0x5EA1C0DE
_GOLD = 0x9E3779B1
#: bytes per partial row sum: a byte times a 32-bit weight is below 2**40
_SUM_SPAN = 1 << 22


@dataclasses.dataclass(frozen=True)
class FECConfig:
    """Parity layout for the sealed boundary payload: ``group_size`` data
    chunks share one XOR parity chunk (~``1/group_size`` overhead plus 4
    bytes of checksum word per chunk); ``n_groups`` parity groups interleave
    the byte stream, so a contiguous burst up to ``n_groups`` chunks wide
    stays repairable. ``enabled`` False builds the plain hop."""

    enabled: bool = True
    group_size: int = 4
    n_groups: int = 4

    def __post_init__(self):
        if not isinstance(self.enabled, bool):
            raise ValueError(f"enabled must be a boolean, got {self.enabled!r}")
        for f in ("group_size", "n_groups"):
            v = getattr(self, f)
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(f"{f} must be an integer >= 1, got {v!r}")

    @property
    def n_data_chunks(self) -> int:
        return self.group_size * self.n_groups

    def chunk_len(self, sealed_nbytes: int) -> int:
        return max(1, -(-int(sealed_nbytes) // self.n_data_chunks))

    def wire_nbytes(self, sealed_nbytes: int) -> int:
        """Byte size of the FEC wire tree for a sealed payload of
        ``sealed_nbytes`` bytes: padded data + parity chunks + one uint32
        checksum word per chunk."""
        n_chunks = self.n_data_chunks + self.n_groups
        return n_chunks * self.chunk_len(sealed_nbytes) + 4 * n_chunks

    def overhead(self, sealed_nbytes: int) -> float:
        """Fractional wire overhead vs sending the sealed payload bare."""
        return self.wire_nbytes(sealed_nbytes) / max(sealed_nbytes, 1) - 1.0


@dataclasses.dataclass(frozen=True)
class HedgeConfig:
    """Hedged-hop mode: send ``routes`` copies per attempt and keep the
    first verified one."""

    enabled: bool = True
    routes: int = 2

    def __post_init__(self):
        if not isinstance(self.enabled, bool):
            raise ValueError(f"enabled must be a boolean, got {self.enabled!r}")
        if (isinstance(self.routes, bool) or not isinstance(self.routes, int)
                or self.routes < 2):
            raise ValueError(f"routes must be an integer >= 2, got {self.routes!r}")


def _chunk_words(chunks: torch.Tensor) -> torch.Tensor:
    """Per-chunk canary-folded weighted byte sums: (C, L) uint8 -> (C,)
    int64 in [0, 2**32). Byte i of chunk c weighs ``(2 * (i + c *
    0x9E3779B1) + 1) * 2654435761`` mod 2**32 (odd: invertible)."""
    n_chunks, chunk_len = chunks.shape
    dev = chunks.device
    i = torch.arange(chunk_len, dtype=torch.int64, device=dev)[None, :]
    salt = ((torch.arange(n_chunks, dtype=torch.int64, device=dev) * _GOLD) & _MASK)[:, None]
    w = _mulmod((2 * ((i + salt) & _MASK) + 1) & _MASK, _CRC_MULT)
    total = torch.zeros((n_chunks,), dtype=torch.int64, device=dev)
    for lo in range(0, chunk_len, _SUM_SPAN):
        part = chunks[:, lo:lo + _SUM_SPAN].to(torch.int64) * w[:, lo:lo + _SUM_SPAN]
        total = (total + part.sum(dim=1)) & _MASK
    return total ^ _CHUNK_CANARY


def fec_encode(sealed: Any, cfg: FECConfig) -> dict:
    """Sealed payload tree -> FEC wire tree ``{"chunks", "words"}``: the
    interleaved data chunks and the parity chunks as one (C, L) uint8
    tensor, and each chunk's locate-checksum as (C,) uint32. Byte i of the
    sealed stream lands in data chunk ``i % n_data_chunks``."""
    stream = flatten_bytes(sealed)
    d = cfg.n_data_chunks
    chunk_len = cfg.chunk_len(stream.numel())
    pad = d * chunk_len - stream.numel()
    if pad:
        stream = torch.cat([stream, stream.new_zeros((pad,))])
    data = stream.reshape(chunk_len, d).t()  # (d, L): chunk c = bytes i % d == c
    grouped = data.reshape(cfg.group_size, cfg.n_groups, chunk_len)
    parity = grouped[0]
    for s in range(1, cfg.group_size):
        parity = parity ^ grouped[s]
    chunks = torch.cat([data, parity], dim=0).contiguous()
    return {"chunks": chunks, "words": _as_u32(_chunk_words(chunks))}


def fec_decode(wire: dict, cfg: FECConfig, like: Any) -> tuple:
    """Arrived FEC wire tree -> (sealed tree, any chunk bad, repaired), the
    two flags host bools. A mismatching chunk word locates its chunk; a group
    with exactly one bad data chunk and a good parity chunk is repaired by
    the XOR select (a falsely accused chunk, its word corrupted and its
    bytes fine, selects itself). Worse damage is left for the retry
    ladder."""
    chunks, words = wire["chunks"], wire["words"]
    d = cfg.n_data_chunks
    chunk_len = chunks.shape[1]
    bad = _chunk_words(chunks) != _from_u32(words)
    bad_data = bad[:d].reshape(cfg.group_size, cfg.n_groups)
    n_bad = bad_data.sum(dim=0)
    repairable = (n_bad == 1) & ~bad[d:]
    grouped = chunks[:d].reshape(cfg.group_size, cfg.n_groups, chunk_len)
    gx = chunks[d:]  # parity ^ xor(data) == 0 when the group is intact
    for s in range(cfg.group_size):
        gx = gx ^ grouped[s]
    fix = bad_data & repairable[None]
    grouped = torch.where(fix[:, :, None], gx[None] ^ grouped, grouped)
    n = tree_nbytes(like)
    stream = grouped.reshape(d, chunk_len).t().reshape(-1)[:n]
    return unflatten_bytes(stream, like), bool(bad.any()), bool(fix.any())


@graph_contract(
    "fec.hop",
    # per cut: every transmission (attempts x hedge routes) sends the 2-leaf
    # FEC wire tree (chunk matrix + word vector); the driver counts the
    # transmissions this call made and supplies the measured ctx
    hops=lambda ctx: ctx["hops"],
    wire_dtypes=lambda ctx: ctx["wire_dtypes"],
    wire_bytes=lambda ctx: ctx["wire_bytes"],
    host_syncs={
        "codecs/fec.py:healing_hop":
            "the verify flag decides on the host whether to retransmit "
            "(the reference unrolls every attempt on the device)",
        "codecs/fec.py:fec_decode":
            "the repair verdicts are host booleans the counters read",
        "codecs/faults.py:inject_faults":
            "the fault draws key on host words copied to the card a leaf",
        "utils/prng.py:bernoulli":
            "a fault rate becomes a card scalar a draw"},
    launches=lambda ctx: {"causal_attention": ctx["layers"],
                          **hop_launches(ctx["codecs"], decodes=ctx["transmissions"])})
def healing_hop(link: Any, codec: Any, hidden: torch.Tensor, s: int, dst,
                key: torch.Tensor, counters: dict,
                hop_imp: Optional[torch.Tensor] = None) -> tuple:
    """One self-healing crossing of cut ``s`` to ``dst``: seal, (FEC-encode,)
    then per attempt ``routes`` copies, transmission t with the injection
    key ``fold_in(fold_in(key, s), t)``; on arrival locate + XOR-repair bad
    chunks before the seal's verdict. ``detected`` counts corrupted arrivals
    (repaired ones too), ``repaired`` those healed in band, ``hedge_wins``
    the hops a non-primary route delivered first, ``retried`` the attempts
    that re-transmitted. Bumps ``counters`` in place; returns the delivered
    hidden."""
    fec = link.fec if (link.fec is not None and link.fec.enabled) else None
    routes = link.hedge.routes if link.hedge is not None and link.hedge.enabled else 1
    payload = encode_hop(codec, hidden, hop_imp)
    over_budget = (link.faults.byte_budget is not None
                   and tree_nbytes(payload) > link.faults.byte_budget)
    sealed = seal_payload(payload)
    wire = fec_encode(sealed, fec) if fec is not None else sealed
    k_hop = fold(key, s)
    counters["hops"][s] += 1
    if over_budget:
        counters["budget_dropped"][s] += 1
    ok, first_fail, decoded, last_dec, t = False, False, None, None, 0
    for a in range(1 + link.policy.max_retries):
        if ok:
            break
        if a > 0:
            counters["retried"][s] += 1
        for r in range(routes):
            take = not ok  # no earlier copy verified yet
            moved = transport(inject_faults(wire, fold(k_hop, t), link.faults), dst)
            if fec is not None:
                arrived, arrived_bad, did_repair = fec_decode(moved, fec, sealed)
            else:
                arrived = moved
            ok_a = not over_budget and bool(verify_payload(arrived))
            dec_a = codec.decode(arrived["p"])
            if take:
                last_dec = dec_a
                if ok_a:
                    decoded = dec_a
                if fec is not None:
                    # chunk words can collide on multi-byte damage; the outer
                    # seal is the authority, so a failed verdict counts detected
                    counters["detected"][s] += int(arrived_bad or not ok_a)
                    counters["repaired"][s] += int(did_repair and ok_a)
                else:
                    counters["detected"][s] += int(not ok_a)
                if routes > 1 and r > 0:
                    counters["hedge_wins"][s] += int(ok_a)
            if t == 0:
                first_fail = not ok_a
            ok = ok or ok_a
            t += 1
    counters["recovered"][s] += int(ok and first_fail)
    counters["substituted"][s] += int(not ok)
    return finish_hop(link.policy, hidden, ok, decoded, last_dec, dst)


# ---------------------------------------------------------------------------
# host-side SLO control
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkHealthConfig:
    """SLO budget for :class:`LinkHealth`. ``error_budget`` is the tolerated
    fraction of hops left corrupted after in-band repair; the burn rate is
    the windowed unrepaired-corruption rate over it. ``degrade_burn`` /
    ``promote_burn`` are the switch thresholds (``promote_burn`` strictly
    below), ``min_dwell_s`` the clock floor between switches."""

    window: int = 16
    error_budget: float = 0.02
    degrade_burn: float = 1.0
    promote_burn: float = 0.25
    min_dwell_s: float = 0.0

    def __post_init__(self):
        if (isinstance(self.window, bool) or not isinstance(self.window, int)
                or self.window < 1):
            raise ValueError(f"window must be an integer >= 1, got {self.window!r}")
        for f, lo, hi in (("error_budget", 0.0, 1.0),
                          ("degrade_burn", 0.0, float("inf")),
                          ("promote_burn", 0.0, float("inf")),
                          ("min_dwell_s", 0.0, float("inf"))):
            v = getattr(self, f)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"{f} must be a number, got {v!r}")
            if not lo <= v <= hi or (f in ("error_budget", "degrade_burn") and v <= 0):
                raise ValueError(f"{f} out of range: {v!r}")
        if self.promote_burn >= self.degrade_burn:
            raise ValueError(
                f"promote_burn ({self.promote_burn}) must be below "
                f"degrade_burn ({self.degrade_burn}) — no hysteresis band")


#: the counter names LinkHealth folds into its window (missing keys read 0)
_HEALTH_KEYS = ("hops", "detected", "repaired", "retried", "substituted", "hedge_wins")


class LinkHealth:
    """Host-side link SLO tracker and tier controller.

    ``observe(delta)`` once per chunk with that chunk's counter deltas. Over
    a full sliding window it burns the error budget with the *unrepaired*
    corruption rate: ``burn >= degrade_burn`` steps the codec tier down,
    ``burn <= promote_burn`` steps it back up. Every switch clears the
    window and arms the ``min_dwell_s`` clock. Window and tier mutate under
    ``_lock``."""

    def __init__(self, n_tiers: int = 1, config: Optional[LinkHealthConfig] = None,
                 clock: Clock = MONOTONIC):
        if n_tiers < 1:
            raise ValueError("need at least one tier")
        self.cfg = config if config is not None else LinkHealthConfig()
        self.n_tiers = n_tiers
        self.clock = clock
        self._lock = threading.Lock()
        self.tier = 0
        self.switches = 0
        self.observations = 0
        self._window: deque = deque(maxlen=self.cfg.window)
        self._last_switch: Optional[float] = None

    def observe(self, counters: Optional[dict]) -> int:
        tot = {k: 0 for k in _HEALTH_KEYS}
        if counters:
            for k in _HEALTH_KEYS:
                if k in counters:
                    tot[k] = int(np.asarray(counters[k]).sum())
        with self._lock:
            self._window.append(tot)
            self.observations += 1
            if len(self._window) == self.cfg.window:
                burn = self._burn_rate_locked()
                now = self.clock()
                dwell_ok = (self._last_switch is None
                            or now - self._last_switch >= self.cfg.min_dwell_s)
                if burn >= self.cfg.degrade_burn and dwell_ok and self.tier < self.n_tiers - 1:
                    self.tier += 1
                    self.switches += 1
                    self._last_switch = now
                    self._window.clear()
                elif burn <= self.cfg.promote_burn and dwell_ok and self.tier > 0:
                    self.tier -= 1
                    self.switches += 1
                    self._last_switch = now
                    self._window.clear()
            tier = self.tier
        self._publish()
        return tier

    def _publish(self) -> None:
        """Mirror the windowed SLO fields into the global obs registry; with
        observability off, one attribute check an observation."""
        from ..obs.metrics import get_registry, record_link_health

        if get_registry().enabled:
            record_link_health(self.summary())

    def _sum_locked(self, key: str) -> int:
        return sum(o[key] for o in self._window)

    def _rate_locked(self, num: str, den: str) -> float:
        return self._sum_locked(num) / max(self._sum_locked(den), 1)

    def _burn_rate_locked(self) -> float:
        unrepaired = self._sum_locked("detected") - self._sum_locked("repaired")
        return (unrepaired / max(self._sum_locked("hops"), 1)) / self.cfg.error_budget

    @property
    def corruption_rate(self) -> float:
        with self._lock:
            return self._rate_locked("detected", "hops")

    @property
    def repair_rate(self) -> float:
        """Fraction of detected corruption healed in band."""
        with self._lock:
            return self._rate_locked("repaired", "detected")

    @property
    def retry_rate(self) -> float:
        with self._lock:
            return self._rate_locked("retried", "hops")

    @property
    def hedge_win_rate(self) -> float:
        with self._lock:
            return self._rate_locked("hedge_wins", "hops")

    @property
    def burn_rate(self) -> float:
        """Windowed unrepaired-corruption rate over the error budget; >= 1
        means the link is out of SLO at the current tier."""
        with self._lock:
            return self._burn_rate_locked()

    def summary(self) -> dict:
        with self._lock:
            return {
                "tier": self.tier,
                "switches": self.switches,
                "observations": self.observations,
                "window": len(self._window),
                "error_budget": self.cfg.error_budget,
                "burn_rate": self._burn_rate_locked(),
                "corruption_rate": self._rate_locked("detected", "hops"),
                "repair_rate": self._rate_locked("repaired", "detected"),
                "retry_rate": self._rate_locked("retried", "hops"),
                "hedge_win_rate": self._rate_locked("hedge_wins", "hops"),
            }


__all__ = ["FECConfig", "HedgeConfig", "fec_encode", "fec_decode", "healing_hop",
           "LinkHealthConfig", "LinkHealth"]
