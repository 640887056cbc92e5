"""Page-table KV cache for continuous batching: PyTorch counterpart of
``edgellm_tpu/models/paged_kv.py``.

One shared pool of fixed-size pages per layer,

    k, v: (L, num_pages, page_size, KV, hd)

preallocated on the device, and a host-side allocator that maps each stream
(a *slot*) to an ordered list of pages: logical position ``p`` of slot ``i``
lives at ``page_table[i, p // page_size]``, offset ``p % page_size``. The page
table and the per-slot lengths go to the ragged step as small int32 tensors,
so one step serves every admit / evict / fill state of a pool geometry.

Conventions (the reference's):

- page 0 is the TRASH page: never allocated, written by inactive slots (their
  page-table rows are all zero, their length 0). Its rows are garbage but
  always finite (inactive slots run real token-0 math), so masked attention
  positions contribute exactly 0.
- pages store POST-ROTARY keys at ``num_kv_heads`` width, the values the
  contiguous cache stores; gathering a slot's pages in order reproduces that
  slot's contiguous cache prefix byte for byte.
- prefix sharing: per-page refcounts, a radix index of token blocks
  (:class:`PrefixIndex`) and copy-on-write forks of shared pages.
- KV at rest: "fp" pages in the cache dtype, or "int8_per_channel" /
  "int4_per_channel" codes with one fp32 scale per (row, KV head); every
  page move (defrag, COW) is a byte move, and a cross-tier payload is refused.
- ``materialize=False``: the allocator alone (page table, free list,
  refcounts, prefix index) with no device pool, for the split batcher whose
  pages live per stage (``SplitRuntime.init_paged_pool``); every method that
  needs the pool raises, and :meth:`PagedKVCache.ensure_writable` hands its
  COW pairs back for the caller to copy.
- migration holds (disaggregated prefill): :meth:`PagedKVCache.hold_slot`
  pins a slot whose pages are in flight to another pool (``free_slot``
  refuses it, ``defrag`` defers), and :meth:`PagedKVCache.gather_slot_rows`
  / :meth:`PagedKVCache.gather_slot_rows_packed` read one page's rows.

Where the reference donates its pool buffers to jitted surgery, the port
updates the pool tensors in place: page writes are ``index_copy_`` / indexed
assignment into the flat (L, num_pages * page_size, ...) row view.

The ragged decode step (:func:`paged_decode_step`, and
:func:`paged_decode_step_quant` for the quantized tiers) runs one layer body,
:func:`block_decode_paged` / :func:`block_decode_paged_quant`, per layer, the
body the split runtime's stages run too; its attention is K13 / K14 on the
card where :func:`~.flash_attention.decode_plan` admits the shape.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..lint import graph_contract
from .configs import ModelConfig
from .flash_attention import (dequantize_kv_rows, paged_decode_attention,
                              paged_decode_attention_plain,
                              paged_decode_attention_quant_plain, paged_plan,
                              paged_decode_attention_quant, quantize_kv_rows)
from .transformer import (_cast_params, _rotate_half, block_with, embed, precompute_rope,
                          project_out, project_qkv, unembed)

#: slot id a page belongs to when it is on the free list
FREE = -1

#: owner sentinel for a page referenced by more than one holder (several
#: slots, or a slot plus the prefix index): no single slot may write it
SHARED = -2


@dataclass(frozen=True)
class PrefixCacheConfig:
    """Knobs for prefix sharing over the paged pool.

    min_shared_block: minimum matched prefix length (tokens) before an admit
        takes the shared path.
    max_index_pages: cap on the number of index NODES (each pins one page);
        0 = uncapped. At the cap, registration evicts LRU leaves first.
    """

    enabled: bool = True
    min_shared_block: int = 1
    max_index_pages: int = 0

    def __post_init__(self):
        if self.min_shared_block < 1:
            raise ValueError(f"min_shared_block must be >= 1, got "
                             f"{self.min_shared_block}")
        if self.max_index_pages < 0:
            raise ValueError(f"max_index_pages must be >= 0 (0 = uncapped), "
                             f"got {self.max_index_pages}")


class _PrefixNode:
    """One page's worth of a registered prompt prefix: a token-id block and
    the page holding its post-rotary K/V, valid under this node's path.
    ``full`` nodes cover exactly ``page_size`` tokens and may have children;
    ``partial`` nodes cover a prompt's tail and are always leaves."""

    __slots__ = ("tokens", "page", "full", "parent", "children", "partials",
                 "stamp")

    def __init__(self, tokens: tuple, page: int, full: bool,
                 parent: Optional["_PrefixNode"], stamp: int):
        self.tokens = tokens
        self.page = page
        self.full = full
        self.parent = parent
        self.children: dict[tuple, _PrefixNode] = {}
        self.partials: list[_PrefixNode] = []
        self.stamp = stamp

    @property
    def is_leaf(self) -> bool:
        return not self.children and not self.partials


class PrefixIndex:
    """Radix index over page-granular token blocks, keyed by the token-id
    block itself (a tuple). Depth j is page j of a prompt; LRU stamps order
    eviction, which always drops leaves first."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _PrefixNode((), 0, True, None, 0)
        self._clock = 0
        self._count = 0

    @property
    def num_nodes(self) -> int:
        return self._count

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def touch(self, node: _PrefixNode) -> None:
        """Refresh the LRU stamp of ``node`` and its whole path (parents are
        never older than their children)."""
        self._tick()
        while node is not None and node is not self.root:
            node.stamp = self._clock
            node = node.parent

    def iter_nodes(self) -> Iterator[_PrefixNode]:
        """Every node except the root, preorder (parents first)."""
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is not self.root:
                yield node
            stack.extend(node.partials)
            stack.extend(node.children.values())

    def leaves(self) -> list[_PrefixNode]:
        return [n for n in self.iter_nodes() if n.is_leaf]

    def match(self, tokens) -> list[tuple[_PrefixNode, int]]:
        """Longest page-aligned match of ``tokens``: [(node, claimed_tokens),
        ...] along the path; full interior blocks claim ``page_size`` tokens,
        one final node may claim fewer (the common prefix with a partial
        leaf, or with a full block the request diverges inside)."""
        ps = self.page_size
        out: list[tuple[_PrefixNode, int]] = []
        node = self.root
        j = 0
        while (j + 1) * ps <= len(tokens):
            key = tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                break
            out.append((child, ps))
            node = child
            j += 1
        rest = [int(t) for t in tokens[j * ps:]]
        best, best_m = None, 0
        for cand in list(node.partials) + list(node.children.values()):
            m = 0
            for a, b in zip(cand.tokens, rest):
                if a != b:
                    break
                m += 1
            if m > best_m:
                best, best_m = cand, m
        if best is not None and best_m > 0:
            out.append((best, best_m))
        return out

    def insert_full(self, parent: _PrefixNode, key: tuple, page: int) -> _PrefixNode:
        node = _PrefixNode(key, page, True, parent, self._tick())
        parent.children[key] = node
        self._count += 1
        return node

    def insert_partial(self, parent: _PrefixNode, tokens: tuple, page: int) -> _PrefixNode:
        node = _PrefixNode(tokens, page, False, parent, self._tick())
        parent.partials.append(node)
        self._count += 1
        return node

    def remove(self, node: _PrefixNode) -> None:
        """Detach a LEAF node."""
        assert node.is_leaf, "only leaves are removable"
        parent = node.parent
        if node.full:
            del parent.children[node.tokens]
        else:
            parent.partials.remove(node)
        node.parent = None
        self._count -= 1

    def to_array(self) -> np.ndarray:
        """Flatten to one int64 array: per node (preorder)
        ``[depth, full, page, stamp, ntok, tok...]``."""
        rows: list[int] = []

        def walk(node: _PrefixNode, depth: int) -> None:
            for child in list(node.children.values()) + node.partials:
                rows.extend([depth, int(child.full), child.page, child.stamp,
                             len(child.tokens)])
                rows.extend(int(t) for t in child.tokens)
                walk(child, depth + 1)

        walk(self.root, 0)
        return np.asarray(rows, np.int64)

    def load_array(self, flat: np.ndarray) -> None:
        """Rebuild from :meth:`to_array` output (clears current contents)."""
        self.root = _PrefixNode((), 0, True, None, 0)
        self._count = 0
        flat = np.asarray(flat, np.int64)
        path = [self.root]
        i = 0
        while i < flat.size:
            depth, full, page, stamp, ntok = (int(x) for x in flat[i:i + 5])
            tokens = tuple(int(t) for t in flat[i + 5:i + 5 + ntok])
            i += 5 + ntok
            parent = path[depth]
            node = (self.insert_full(parent, tokens, page) if full
                    else self.insert_partial(parent, tokens, page))
            node.stamp = stamp
            del path[depth + 1:]
            path.append(node)
        self._clock = max((n.stamp for n in self.iter_nodes()), default=0)


class OutOfPages(RuntimeError):
    """The pool has no free page for a slot that must grow: the scheduler's
    signal to evict (or refuse to admit) a stream."""


class OutOfSlots(RuntimeError):
    """Every slot of the step shape is occupied."""


class KVTierMismatchError(ValueError):
    """A KV payload at one ``kv_codec`` tier was offered to a pool built at
    another. Every adoption surface raises this type (never a transcode)."""

    def __init__(self, *, offered: str, pool: str, where: str, detail: str = ""):
        self.offered = offered
        self.pool = pool
        self.where = where
        super().__init__(
            f"KV tier mismatch in {where}: payload is {offered!r}, pool is "
            f"{pool!r}; rebuild the pool at kv_codec={offered!r} "
            f"(at-rest transcoding is refused)"
            + (f" — {detail}" if detail else ""))


class PagePool(NamedTuple):
    """Device page pool: post-rotary K/V at ``num_kv_heads`` width, k, v:
    (L, num_pages, page_size, KV, hd). Page 0 is the trash page."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[2]


def _check_geometry(num_pages: int, page_size: int) -> None:
    if num_pages < 2:
        raise ValueError(f"num_pages must be >= 2 (page 0 is reserved), got {num_pages}")
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")


def init_pool(cfg: ModelConfig, num_pages: int, page_size: int,
              dtype: torch.dtype = torch.float32, device="cuda") -> PagePool:
    """An all-zero pool on ``device``; ``num_pages`` INCLUDES the trash page."""
    _check_geometry(num_pages, page_size)
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    return PagePool(torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))


@dataclass(frozen=True)
class KVPageCodec:
    """One KV-at-rest storage tier. ``bits=0`` marks the fp tier (codes are
    the pool dtype, no scales); quantized tiers store ``code_lanes(hd)``
    code bytes plus one fp32 absmax scale per (token row, KV head)."""

    name: str
    bits: int
    code_dtype: Optional[torch.dtype]

    @property
    def quantized(self) -> bool:
        return self.bits > 0

    def code_lanes(self, head_dim: int) -> int:
        """Last-axis width of a code row (int4 packs two lanes per byte)."""
        if self.bits == 4:
            if head_dim % 2:
                raise ValueError(f"int4 packing needs an even head_dim, got {head_dim}")
            return head_dim // 2
        return head_dim

    def row_bytes(self, head_dim: int, dtype: torch.dtype = torch.float32) -> int:
        """Device bytes per (token row, KV head) for K or V: codes + scale."""
        if not self.quantized:
            return head_dim * dtype.itemsize
        return self.code_lanes(head_dim) + 4


KV_PAGE_CODECS = {
    "fp": KVPageCodec("fp", 0, None),
    "int8_per_channel": KVPageCodec("int8_per_channel", 8, torch.int8),
    "int4_per_channel": KVPageCodec("int4_per_channel", 4, torch.uint8),
}


def resolve_kv_codec(name: str) -> KVPageCodec:
    """Registry lookup that refuses unknown tier names."""
    try:
        return KV_PAGE_CODECS[name]
    except (KeyError, TypeError):
        raise ValueError(f"unknown kv_codec {name!r}; available tiers: "
                         f"{sorted(KV_PAGE_CODECS)}") from None


class QuantPagePool(NamedTuple):
    """Quantized device pool: k, v (L, num_pages, page_size, KV, hdc) codes
    (hdc = hd for int8, hd/2 for packed int4) and k_scale, v_scale
    (L, num_pages, page_size, KV) fp32 absmax scales."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[2]


def init_quant_pool(cfg: ModelConfig, num_pages: int, page_size: int, kv_codec: str,
                    device="cuda") -> QuantPagePool:
    """All-zero quantized pool (zero codes with zero scales dequantize to
    zeros, so the trash page starts finite)."""
    codec = resolve_kv_codec(kv_codec)
    if not codec.quantized:
        raise ValueError("init_quant_pool is for quantized tiers; use init_pool for fp")
    _check_geometry(num_pages, page_size)
    hdc = codec.code_lanes(cfg.head_dim)
    cshape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, hdc)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return QuantPagePool(z(cshape, codec.code_dtype), z(cshape, codec.code_dtype),
                         z(cshape[:-1], torch.float32), z(cshape[:-1], torch.float32))


def kv_page_bytes(cfg: ModelConfig, page_size: int, kv_codec: str = "fp",
                  dtype: torch.dtype = torch.float32) -> int:
    """Device bytes ONE page costs across all layers (K + V, codes + scales)."""
    codec = resolve_kv_codec(kv_codec)
    return (2 * cfg.num_layers * page_size * cfg.num_kv_heads
            * codec.row_bytes(cfg.head_dim, dtype))


def num_pages_for_bytes(cfg: ModelConfig, pool_bytes: int, page_size: int,
                        kv_codec: str = "fp", dtype: torch.dtype = torch.float32) -> int:
    """Pages (trash page included) a fixed byte budget buys at a tier."""
    pages = int(pool_bytes) // kv_page_bytes(cfg, page_size, kv_codec, dtype)
    if pages < 2:
        raise ValueError(
            f"pool budget {pool_bytes} bytes buys {pages} {kv_codec} "
            f"page(s); need >= 2 (page 0 is reserved)")
    return pages


# ---------------------------------------------------------------------------
# Pool surgery, in place on the flat (L, num_pages * page_size, ...) row view
# ---------------------------------------------------------------------------


def _flat(arr: torch.Tensor) -> torch.Tensor:
    """(L, num_pages, page_size, ...) -> the (L, num_pages * page_size, ...)
    view whose axis 1 is the flat token row."""
    return arr.view((arr.shape[0], arr.shape[1] * arr.shape[2]) + tuple(arr.shape[3:]))


def _rows_set(arr: torch.Tensor, dest: torch.Tensor, rows) -> None:
    """Write (L, S, ...) rows at flat token positions ``dest`` (S,)."""
    rows = torch.as_tensor(rows).to(device=arr.device, dtype=arr.dtype)
    _flat(arr)[:, dest] = rows


def _rows_get(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _flat(arr)[:, idx]


def _host(t: torch.Tensor) -> np.ndarray:
    """A pool slice as host numpy (bf16 widened to fp32, exactly)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


class PagedKVCache:
    """Host-side allocator + device pool for up to ``max_slots`` concurrent
    streams of up to ``pages_per_slot * page_size`` tokens each.

    The device state is ``self.pool``, updated in place; the host state is
    the page table, per-slot lengths, the free list, per-page ownership,
    refcounts and the prefix index. :meth:`device_tables` makes the int32
    tensors of the ragged step. Every mutating method keeps
    :meth:`check_invariants` true."""

    def __init__(self, cfg: ModelConfig, *, num_pages: int, page_size: int,
                 max_slots: int, pages_per_slot: int,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 materialize: bool = True,
                 prefix_cache: Optional[PrefixCacheConfig] = None,
                 kv_codec: str = "fp"):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if pages_per_slot < 1:
            raise ValueError(f"pages_per_slot must be >= 1, got {pages_per_slot}")
        self.cfg = cfg
        self.kv_codec = resolve_kv_codec(kv_codec).name
        self.device = torch.device(device)
        if not materialize:  # bookkeeping only: the pages live elsewhere
            _check_geometry(num_pages, page_size)
            self.pool = None
        elif self.kv_codec == "fp":
            self.pool = init_pool(cfg, num_pages, page_size, dtype, self.device)
        else:
            self.pool = init_quant_pool(cfg, num_pages, page_size, self.kv_codec, self.device)
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_slots = max_slots
        self.pages_per_slot = pages_per_slot
        self.page_table = np.zeros((max_slots, pages_per_slot), np.int32)
        self.lengths = np.zeros((max_slots,), np.int32)
        self.active = np.zeros((max_slots,), bool)
        # LIFO free list, low pages first out: deterministic layouts
        self._free = list(range(num_pages - 1, 0, -1))
        self._slot_pages: list[list[int]] = [[] for _ in range(max_slots)]
        self._owner = np.full((num_pages,), FREE, np.int32)
        self._refcount = np.zeros((num_pages,), np.int32)
        self._index_holds = np.zeros((num_pages,), np.int32)
        self.prefix_cfg = prefix_cache
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex(page_size)
            if prefix_cache is not None and prefix_cache.enabled else None)
        self.prefix_counters = {"hits": 0, "misses": 0, "saved_tokens": 0,
                                "cow_forks": 0, "index_evictions": 0,
                                "reclaimed_pages": 0}
        # migration holds: slots pinned while their pages are in flight to
        # another pool; free_slot refuses a held slot and defrag defers, so
        # the flat indices a transfer read stay valid until it lands
        self._slot_holds = np.zeros((max_slots,), np.int32)
        self.deferred_defrags = 0

    # -- geometry ----------------------------------------------------------

    @property
    def span(self) -> int:
        """Max positions one slot can hold: the attention width."""
        return self.pages_per_slot * self.page_size

    @property
    def num_free_pages(self) -> int:
        return len(self._free)

    @property
    def token_capacity(self) -> int:
        """Allocatable token positions (the trash page excluded)."""
        return (self.num_pages - 1) * self.page_size

    @property
    def live_tokens(self) -> int:
        return int(self.lengths[self.active].sum())

    @property
    def unique_live_tokens(self) -> int:
        """Live tokens counting each physical page once (the max coverage
        over every slot referencing it)."""
        cover = np.zeros((self.num_pages,), np.int64)
        for s in range(self.max_slots):
            if not self.active[s]:
                continue
            n = int(self.lengths[s])
            for j, p in enumerate(self._slot_pages[s]):
                c = min(self.page_size, n - j * self.page_size)
                if c > 0:
                    cover[p] = max(cover[p], c)
        return int(cover.sum())

    @property
    def shared_pages(self) -> int:
        return int(np.sum(self._refcount > 1))

    @property
    def index_pages(self) -> int:
        return int(np.sum(self._index_holds > 0))

    @property
    def reclaimable_index_pages(self) -> int:
        """Pages held ONLY by the index (``ensure`` frees these under
        pressure, so admission may count them as available)."""
        return int(np.sum((self._refcount == 1) & (self._index_holds == 1)))

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    # -- slot lifecycle ----------------------------------------------------

    def alloc_slot(self) -> int:
        """Claim the lowest free slot (deterministic admit order)."""
        for s in range(self.max_slots):
            if not self.active[s]:
                self.active[s] = True
                self.lengths[s] = 0
                return s
        raise OutOfSlots(f"all {self.max_slots} slots active")

    def ensure(self, slot: int, new_length: int) -> None:
        """Grow ``slot``'s page list to cover ``new_length`` positions;
        index-only pages are reclaimed LRU-first under pressure. Raises
        :class:`OutOfPages` (allocating nothing) when the pool cannot cover
        the growth."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        if new_length > self.span:
            raise ValueError(f"length {new_length} exceeds slot span {self.span}")
        need = self.pages_for(new_length) - len(self._slot_pages[slot])
        if need <= 0:
            return
        if need > len(self._free):
            self._reclaim_index_pages(need - len(self._free))
        if need > len(self._free):
            raise OutOfPages(f"slot {slot} needs {need} page(s), {len(self._free)} free")
        for _ in range(need):
            p = self._free.pop()
            self._owner[p] = slot
            self._refcount[p] = 1
            self.page_table[slot, len(self._slot_pages[slot])] = p
            self._slot_pages[slot].append(p)

    def free_slot(self, slot: int) -> None:
        """Release a slot; each page drops one reference and returns to the
        free list only at refcount 0. Page contents are left stale."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        if self._slot_holds[slot]:
            raise ValueError(
                f"slot {slot} is held for an in-flight migration "
                f"({int(self._slot_holds[slot])} hold(s)); release the hold "
                f"before freeing")
        for p in reversed(self._slot_pages[slot]):
            self._release_ref(p)
        self._slot_pages[slot] = []
        self.page_table[slot] = 0
        self.lengths[slot] = 0
        self.active[slot] = False

    # -- migration holds ---------------------------------------------------

    def hold_slot(self, slot: int) -> None:
        """Pin ``slot`` for an in-flight page handoff: while a hold is out,
        :meth:`free_slot` refuses the slot and :meth:`defrag` defers (returns
        0, counted in ``deferred_defrags``), so the source rows of a
        transfer's retries stay where its flat indices point."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self._slot_holds[slot] += 1

    def release_slot_hold(self, slot: int) -> None:
        """Drop one migration hold on ``slot``."""
        if self._slot_holds[slot] <= 0:
            raise ValueError(f"slot {slot} has no outstanding hold")
        self._slot_holds[slot] -= 1

    @property
    def held_slots(self) -> list:
        return [s for s in range(self.max_slots) if self._slot_holds[s] > 0]

    # -- reference counting / prefix sharing -------------------------------

    def _release_ref(self, p: int) -> None:
        assert self._refcount[p] > 0, f"refcount underflow on page {p}"
        self._refcount[p] -= 1
        if self._refcount[p] == 0:
            self._owner[p] = FREE
            self._free.append(p)
        else:
            self._recompute_owner(p)

    def _recompute_owner(self, p: int) -> None:
        if self._refcount[p] == 0:
            self._owner[p] = FREE
            return
        holders = [s for s in range(self.max_slots) if p in self._slot_pages[s]]
        if len(holders) == 1 and self._index_holds[p] == 0:
            self._owner[p] = holders[0]
        else:
            self._owner[p] = SHARED

    def _drop_index_hold(self, p: int) -> None:
        assert self._index_holds[p] > 0
        self._index_holds[p] -= 1
        self._release_ref(p)

    def _add_index_hold(self, p: int) -> None:
        self._index_holds[p] += 1
        self._refcount[p] += 1
        self._owner[p] = SHARED

    def _evict_index_leaf(self, node) -> None:
        self.prefix.remove(node)
        self.prefix_counters["index_evictions"] += 1
        self._drop_index_hold(node.page)

    def _reclaim_index_pages(self, want: int) -> int:
        """Free up to ``want`` pages by evicting LRU index leaves held only by
        the index (repeats so a freed leaf exposes its parent)."""
        if self.prefix is None:
            return 0
        freed = 0
        while freed < want:
            candidates = [n for n in self.prefix.leaves() if self._refcount[n.page] == 1]
            if not candidates:
                break
            self._evict_index_leaf(min(candidates, key=lambda n: (n.stamp, n.page)))
            freed += 1
        self.prefix_counters["reclaimed_pages"] += freed
        return freed

    def _claim(self, tokens, max_tokens: Optional[int]):
        """(claimed tokens, matched nodes) of the longest indexed prefix,
        capped at ``max_tokens``."""
        limit = len(tokens) if max_tokens is None else min(int(max_tokens), len(tokens))
        claimed, nodes = 0, []
        for node, claim in self.prefix.match(tokens):
            take = min(claim, limit - claimed)
            if take <= 0:
                break
            claimed += take
            nodes.append(node)
        return claimed, nodes

    def _min_shared(self) -> int:
        return self.prefix_cfg.min_shared_block if self.prefix_cfg else 1

    def probe_prefix(self, tokens, max_tokens: Optional[int] = None) -> dict:
        """Dry run of :meth:`share_prefix`: {"tokens": claimable prefix,
        "pages": index pages a match would map, "forks": COW forks the
        suffix write would trigger}."""
        if self.prefix is None:
            return {"tokens": 0, "pages": 0, "forks": 0}
        claimed, nodes = self._claim(tokens, max_tokens)
        if claimed < self._min_shared():
            return {"tokens": 0, "pages": 0, "forks": 0}
        return {"tokens": claimed, "pages": len(nodes),
                "forks": 1 if claimed % self.page_size else 0}

    def share_prefix(self, slot: int, tokens, max_tokens: Optional[int] = None) -> int:
        """Map the longest indexed prefix of ``tokens`` into a FRESH slot's
        page table with zero data movement; returns the claimed length (0 =
        miss or below ``min_shared_block``)."""
        if self.prefix is None:
            return 0
        if not self.active[slot] or self._slot_pages[slot]:
            raise ValueError(
                f"share_prefix needs a fresh active slot; slot {slot} "
                f"already owns {len(self._slot_pages[slot])} page(s)")
        claimed, nodes = self._claim(tokens, max_tokens)
        if claimed < self._min_shared():
            self.prefix_counters["misses"] += 1
            return 0
        for node in nodes:
            p = node.page
            self._refcount[p] += 1
            self._owner[p] = SHARED
            self.page_table[slot, len(self._slot_pages[slot])] = p
            self._slot_pages[slot].append(p)
            self.prefix.touch(node)
        self.lengths[slot] = claimed
        self.prefix_counters["hits"] += 1
        self.prefix_counters["saved_tokens"] += claimed
        return claimed

    def _index_make_room(self, protect: set) -> bool:
        """Honor ``max_index_pages``: evict LRU leaves (never ``protect``)
        until a node fits; False when every evictable leaf is protected."""
        cap = self.prefix_cfg.max_index_pages if self.prefix_cfg else 0
        if cap <= 0:
            return True
        while self.prefix.num_nodes >= cap:
            candidates = [n for n in self.prefix.leaves() if n not in protect]
            if not candidates:
                return False
            self._evict_index_leaf(min(candidates, key=lambda n: (n.stamp, n.page)))
        return True

    def register_prefix(self, slot: int, tokens) -> int:
        """Publish ``slot``'s prompt pages into the index: one full-block node
        per fully covered page plus one partial leaf for the tail. Returns
        the number of nodes added."""
        if self.prefix is None:
            return 0
        ps = self.page_size
        pages = self._slot_pages[slot]
        node = self.prefix.root
        added = 0
        walked: set = set()
        j = 0
        while (j + 1) * ps <= len(tokens) and j < len(pages):
            key = tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                if not self._index_make_room(walked):
                    return added
                child = self.prefix.insert_full(node, key, pages[j])
                self._add_index_hold(pages[j])
                added += 1
            else:
                self.prefix.touch(child)
            walked.add(child)
            node = child
            j += 1
        tail = tuple(int(t) for t in tokens[j * ps:])
        if tail and j < len(pages):
            for cand in node.partials:
                if cand.tokens == tail:
                    self.prefix.touch(cand)
                    return added
            if not self._index_make_room(walked):
                return added
            self.prefix.insert_partial(node, tail, pages[j])
            self._add_index_hold(pages[j])
            added += 1
        return added

    def release_prefix(self, tokens=None) -> int:
        """Drop index pins: the whole index (``tokens=None``) or the deepest
        exclusive suffix of one registered path. Returns nodes released."""
        if self.prefix is None:
            return 0
        dropped = 0
        if tokens is None:
            while True:
                leaves = self.prefix.leaves()
                if not leaves:
                    return dropped
                for leaf in leaves:
                    self._evict_index_leaf(leaf)
                    dropped += 1
        for node in reversed([node for node, _ in self.prefix.match(tokens)]):
            if not node.is_leaf:
                break
            self._evict_index_leaf(node)
            dropped += 1
        return dropped

    # -- copy-on-write -----------------------------------------------------

    def fork_page(self, slot: int, page_index: int) -> tuple[int, int]:
        """COW bookkeeping: give ``slot`` a fresh page in place of its shared
        ``page_index``-th page -> (old_page, new_page). The device copy is
        the caller's (:meth:`ensure_writable` does it)."""
        old = self._slot_pages[slot][page_index]
        assert self._refcount[old] > 1, f"fork_page on exclusively-owned page {old}"
        if not self._free:
            self._reclaim_index_pages(1)
        if not self._free:
            raise OutOfPages(f"COW fork for slot {slot} needs a free page, 0 free")
        new = self._free.pop()
        self._refcount[new] = 1
        self._owner[new] = slot
        self._refcount[old] -= 1
        self._recompute_owner(old)
        self._slot_pages[slot][page_index] = new
        self.page_table[slot, page_index] = new
        self.prefix_counters["cow_forks"] += 1
        return old, new

    def prepare_write(self, slot: int, new_length: int, start: Optional[int] = None) -> list:
        """Fork every SHARED page the write range ``[lengths[slot],
        new_length)`` touches (``start`` overrides the left edge), all or
        nothing -> the (old, new) copy list."""
        left = int(self.lengths[slot]) if start is None else int(start)
        first = left // self.page_size
        stop = min(self.pages_for(new_length), len(self._slot_pages[slot]))
        forks = [j for j in range(first, stop)
                 if self._refcount[self._slot_pages[slot][j]] > 1]
        if len(forks) > len(self._free):
            self._reclaim_index_pages(len(forks) - len(self._free))
        if len(forks) > len(self._free):
            raise OutOfPages(f"slot {slot} needs {len(forks)} COW fork(s), "
                             f"{len(self._free)} page(s) free")
        return [self.fork_page(slot, j) for j in forks]

    def ensure_writable(self, slot: int, new_length: int) -> list:
        """:meth:`ensure` + COW: every page covering ``[lengths[slot],
        new_length)`` becomes exclusively ``slot``'s; on a materialized pool
        the page copies (codes and scales alike, byte moves) run here, a
        bookkeeping-only caller applies the returned (old, new) pairs to its
        own pools."""
        self.ensure(slot, new_length)
        pairs = self.prepare_write(slot, new_length)
        if pairs and self.pool is not None:
            src = torch.tensor([o for o, _ in pairs], dtype=torch.long, device=self.device)
            dst = torch.tensor([n for _, n in pairs], dtype=torch.long, device=self.device)
            for arr in self.pool:
                arr[:, dst] = arr[:, src]
        return pairs

    def device_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(page_table (max_slots, pages_per_slot), lengths (max_slots,)) as
        int32 tensors on the pool's device: the ragged step's inputs."""
        return (torch.from_numpy(self.page_table.copy()).to(self.device),
                torch.from_numpy(self.lengths.astype(np.int32)).to(self.device))

    # -- data movement -----------------------------------------------------

    def _require_pool(self, what: str) -> None:
        if self.pool is None:
            raise ValueError(f"{what} needs a materialized pool; this cache was built "
                             f"with materialize=False (bookkeeping-only)")

    def _flat_indices(self, slot: int, n: int) -> np.ndarray:
        pos = np.arange(n)
        return (self.page_table[slot, pos // self.page_size] * self.page_size
                + pos % self.page_size).astype(np.int32)

    def _dest(self, slot: int, n: int, start: int = 0) -> torch.Tensor:
        return torch.from_numpy(self._flat_indices(slot, n)[start:].astype(np.int64)).to(
            self.device)

    def _write_rows(self, dest: torch.Tensor, k_seq, v_seq) -> None:
        """(L, S, KV, hd) post-rotary rows into flat positions ``dest``,
        quantized on append for the quantized tiers."""
        if self.kv_codec == "fp":
            _rows_set(self.pool.k, dest, k_seq)
            _rows_set(self.pool.v, dest, v_seq)
            return
        k_seq = torch.as_tensor(k_seq).to(self.device)
        v_seq = torch.as_tensor(v_seq).to(self.device)
        qk, sk = quantize_kv_rows(k_seq, self.kv_codec)
        qv, sv = quantize_kv_rows(v_seq, self.kv_codec)
        for arr, rows in zip(self.pool, (qk, qv, sk, sv)):
            _rows_set(arr, dest, rows)

    def adopt(self, slot: int, k_seq, v_seq, length: int) -> None:
        """Write a contiguous (L, length, KV, hd) post-rotary K/V prefix into
        ``slot``'s pages and set its length (shared pages in the range are
        COW-forked first, with no device copy: every exposed row is
        overwritten here)."""
        self._require_pool("adopt")
        self.ensure(slot, length)
        self.prepare_write(slot, length, start=0)
        self._write_rows(self._dest(slot, length), k_seq, v_seq)
        self.lengths[slot] = length

    def adopt_rows(self, slot: int, k_seq, v_seq, start: int, stop: int) -> None:
        """Write (L, stop - start, KV, hd) rows into rows ``[start, stop)`` of
        ``slot`` (the prefix-sharing admit's suffix); ``start`` must equal
        the slot's length."""
        self._require_pool("adopt_rows")
        if start != int(self.lengths[slot]):
            raise ValueError(f"adopt_rows start {start} != slot {slot} length "
                             f"{int(self.lengths[slot])}")
        self.ensure_writable(slot, stop)
        self._write_rows(self._dest(slot, stop, start), k_seq, v_seq)
        self.lengths[slot] = stop

    def adopt_packed(self, slot: int, k_codes, v_codes, k_scale, v_scale,
                     length: int) -> None:
        """Write already-packed (L, length, KV, hdc) codes and (L, length, KV)
        scales into ``slot``: no requantize, so the pool bytes equal the
        gathered bytes exactly."""
        self._require_pool("adopt_packed")
        if self.kv_codec == "fp":
            raise KVTierMismatchError(
                offered="quantized", pool=self.kv_codec, where="adopt_packed",
                detail="packed payloads are for quantized tiers; fp pools adopt fp rows "
                       "via adopt()")
        self.ensure(slot, length)
        self.prepare_write(slot, length, start=0)
        dest = self._dest(slot, length)
        for arr, rows in zip(self.pool, (k_codes, v_codes, k_scale, v_scale)):
            _rows_set(arr, dest, rows)
        self.lengths[slot] = length

    def gather_slot(self, slot: int) -> dict:
        """``slot``'s K/V as the contiguous host dict {"k": (L, length, KV,
        hd), "v", "length"}: byte-identical to the contiguous cache prefix on
        the fp tier, dequantized to fp32 on the quantized tiers."""
        self._require_pool("gather_slot")
        n = int(self.lengths[slot])
        k, v = self._gather_fp(self._dest(slot, max(n, 1)))
        return {"k": _host(k)[:, :n], "v": _host(v)[:, :n],
                "length": np.asarray(n, np.int32)}

    def _gather_fp(self, idx: torch.Tensor):
        if self.kv_codec == "fp":
            return _rows_get(self.pool.k, idx), _rows_get(self.pool.v, idx)
        kc, vc, ks, vs = (_rows_get(a, idx) for a in self.pool)
        return (dequantize_kv_rows(kc, ks, self.kv_codec),
                dequantize_kv_rows(vc, vs, self.kv_codec))

    def gather_slot_packed(self, slot: int) -> dict:
        """Quantized-tier eviction form: {"k_codes", "v_codes", "k_scale",
        "v_scale", "length"} host arrays, the raw pool bytes."""
        self._require_pool("gather_slot_packed")
        if self.kv_codec == "fp":
            raise ValueError("gather_slot_packed is for quantized tiers; "
                             "fp pools use gather_slot()")
        n = int(self.lengths[slot])
        idx = self._dest(slot, max(n, 1))
        kc, vc, ks, vs = (_rows_get(a, idx).cpu().numpy()[:, :n] for a in self.pool)
        return {"k_codes": kc, "v_codes": vc, "k_scale": ks, "v_scale": vs,
                "length": np.asarray(n, np.int32)}

    def _check_row_range(self, slot: int, start: int, stop: int) -> None:
        if not 0 <= start < stop <= int(self.lengths[slot]):
            raise ValueError(f"row range [{start}, {stop}) out of slot {slot}'s "
                             f"length {int(self.lengths[slot])}")

    def gather_slot_rows(self, slot: int, start: int, stop: int) -> dict:
        """Rows ``[start, stop)`` of :meth:`gather_slot` as host {"k", "v"}:
        one migrated page's chunk (concatenated along the row axis the
        chunks give :meth:`gather_slot`'s arrays)."""
        self._require_pool("gather_slot_rows")
        self._check_row_range(slot, start, stop)
        k, v = self._gather_fp(self._dest(slot, stop, start))
        return {"k": _host(k), "v": _host(v)}

    def gather_slot_rows_packed(self, slot: int, start: int, stop: int) -> dict:
        """Rows ``[start, stop)`` of :meth:`gather_slot_packed`: the raw pool
        bytes of one migrated page, so the packed adopt on the far side is a
        byte move."""
        self._require_pool("gather_slot_rows_packed")
        if self.kv_codec == "fp":
            raise ValueError("gather_slot_rows_packed is for quantized "
                             "tiers; fp pools use gather_slot_rows()")
        self._check_row_range(slot, start, stop)
        idx = self._dest(slot, stop, start)
        kc, vc, ks, vs = (_rows_get(a, idx).cpu().numpy() for a in self.pool)
        return {"k_codes": kc, "v_codes": vc, "k_scale": ks, "v_scale": vs}

    def defrag(self) -> int:
        """Compact referenced pages to the low end of the pool (slot order,
        then index nodes; a shared page moves once) and rebuild the free list
        above them. Returns the number of pages that moved. Deferred
        (returns 0) while any slot holds a migration pin."""
        self._require_pool("defrag")
        if self._slot_holds.any():
            self.deferred_defrags += 1
            return 0
        src = np.zeros((self.num_pages,), np.int32)  # new -> old; src[0] = 0
        new_of: dict = {}
        moved = 0
        nxt = 1

        def place(p: int) -> int:
            nonlocal moved, nxt
            if p in new_of:
                return new_of[p]
            src[nxt] = p
            if p != nxt:
                moved += 1
            new_of[p] = nxt
            nxt += 1
            return new_of[p]

        for s in range(self.max_slots):
            pages = self._slot_pages[s]
            for j, p in enumerate(pages):
                pages[j] = place(p)
                self.page_table[s, j] = pages[j]
        if self.prefix is not None:
            for node in self.prefix.iter_nodes():
                node.page = place(node.page)
        placed = set(int(x) for x in src[:nxt])
        src[nxt:] = [p for p in range(1, self.num_pages) if p not in placed]
        self._owner = self._owner[src].copy()
        self._refcount = self._refcount[src].copy()
        self._index_holds = self._index_holds[src].copy()
        self._free = list(range(self.num_pages - 1, nxt - 1, -1))
        if moved:
            idx = torch.from_numpy(src.astype(np.int64)).to(self.device)
            for arr in self.pool:
                arr.copy_(arr[:, idx])
        return moved

    # -- serialization -----------------------------------------------------

    def state_dict(self) -> dict:
        """Whole-cache snapshot as host numpy arrays, the reference's keys."""
        self._require_pool("state_dict")
        if self.kv_codec == "fp":
            state = {"k": _host(self.pool.k), "v": _host(self.pool.v)}
        else:
            state = {"kv_codec": self.kv_codec,
                     **{name: a.cpu().numpy() for name, a in
                        zip(("k_codes", "v_codes", "k_scale", "v_scale"), self.pool)}}
        state.update({"page_table": self.page_table.copy(),
                      "lengths": self.lengths.copy(),
                      "active": self.active.copy(),
                      "free": np.asarray(self._free, np.int32),
                      "refcount": self._refcount.copy(),
                      "index_holds": self._index_holds.copy()})
        if self.prefix is not None:
            state["prefix_index"] = self.prefix.to_array()
        return state

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` output (same geometry; a state without
        refcounts derives exclusive ones from the slot tables; a
        sharing-era state restored without an index drops the index holds)."""
        self._require_pool("load_state_dict")
        ck = state.get("kv_codec", "fp")
        if ck != self.kv_codec:
            raise KVTierMismatchError(offered=ck, pool=self.kv_codec, where="load_state_dict")
        names = ("k", "v") if self.kv_codec == "fp" else (
            "k_codes", "v_codes", "k_scale", "v_scale")
        if tuple(state[names[0]].shape) != tuple(self.pool.k.shape):
            raise ValueError(f"pool shape mismatch: checkpoint {state[names[0]].shape} vs "
                             f"cache {tuple(self.pool.k.shape)}")
        for arr, name in zip(self.pool, names):
            arr.copy_(torch.from_numpy(np.array(state[name])))
        self.page_table = np.asarray(state["page_table"], np.int32).copy()
        self.lengths = np.asarray(state["lengths"], np.int32).copy()
        self.active = np.asarray(state["active"], bool).copy()
        self._free = [int(p) for p in state["free"]]
        self._slot_pages = [[] for _ in range(self.max_slots)]
        for s in range(self.max_slots):
            if self.active[s]:
                n = self.pages_for(int(self.lengths[s]))
                self._slot_pages[s] = [int(p) for p in self.page_table[s, :n]]
        if "refcount" in state:
            self._refcount = np.asarray(state["refcount"], np.int32).copy()
            self._index_holds = np.asarray(state["index_holds"], np.int32).copy()
        else:
            self._refcount = np.zeros((self.num_pages,), np.int32)
            self._index_holds = np.zeros((self.num_pages,), np.int32)
            for pages in self._slot_pages:
                for p in pages:
                    self._refcount[p] += 1
        if self.prefix is not None:
            self.prefix = PrefixIndex(self.page_size)
            if state.get("prefix_index") is not None:
                self.prefix.load_array(np.asarray(state["prefix_index"]))
        elif self._index_holds.any():
            for p in np.nonzero(self._index_holds)[0]:
                self._refcount[p] -= self._index_holds[p]
                self._index_holds[p] = 0
                if self._refcount[p] == 0:
                    self._free.append(int(p))
        self._owner = np.full((self.num_pages,), FREE, np.int32)
        for p in range(1, self.num_pages):
            if self._refcount[p] > 0:
                self._recompute_owner(p)

    # -- invariants --------------------------------------------------------

    def check_invariants(self) -> None:
        """Raise AssertionError on any aliasing / leak / ownership / refcount
        violation."""
        assert 0 not in self._free, "trash page 0 on the free list"
        assert self._owner[0] == FREE, "trash page 0 owned by a slot"
        assert self._refcount[0] == 0, "trash page 0 referenced"
        expect = np.zeros((self.num_pages,), np.int32)
        holders: list = [[] for _ in range(self.num_pages)]
        for s, pages in enumerate(self._slot_pages):
            assert len(pages) == len(set(pages)), f"slot {s} references a page twice: {pages}"
            for p in pages:
                expect[p] += 1
                holders[p].append(s)
        index_holds = np.zeros((self.num_pages,), np.int32)
        if self.prefix is not None:
            for node in self.prefix.iter_nodes():
                index_holds[node.page] += 1
                if node.full:
                    assert len(node.tokens) == self.page_size, \
                        f"full index node with {len(node.tokens)} tokens"
                else:
                    assert 0 < len(node.tokens) < self.page_size, \
                        f"partial index node with {len(node.tokens)} tokens"
                    assert node.is_leaf, "partial index node has children"
        expect += index_holds
        assert (self._index_holds == index_holds).all(), \
            f"index holds drifted: {self._index_holds} vs {index_holds}"
        assert (self._refcount == expect).all(), \
            f"refcounts drifted: {self._refcount} vs {expect}"
        referenced = set(int(p) for p in np.nonzero(expect)[0])
        assert not (referenced & set(self._free)), "page both referenced and free"
        assert referenced | set(self._free) == set(range(1, self.num_pages)), \
            "page leaked (neither referenced nor free)"
        for p in range(1, self.num_pages):
            if expect[p] == 0:
                assert self._owner[p] == FREE, f"free page {p} has an owner"
            elif expect[p] == 1 and len(holders[p]) == 1:
                assert self._owner[p] == holders[p][0], \
                    f"exclusive page {p} owner {self._owner[p]} != slot {holders[p][0]}"
            else:
                assert self._owner[p] == SHARED, \
                    f"shared page {p} owner {self._owner[p]} != SHARED"
        for s in range(self.max_slots):
            if self.active[s]:
                assert len(self._slot_pages[s]) * self.page_size >= self.lengths[s], \
                    f"slot {s} pages do not cover its length"
                for j, p in enumerate(self._slot_pages[s]):
                    assert self.page_table[s, j] == p
            else:
                assert not self._slot_pages[s], f"inactive slot {s} owns pages"
                assert (self.page_table[s] == 0).all()
                assert self.lengths[s] == 0
                assert self._slot_holds[s] == 0, f"inactive slot {s} carries a migration hold"

    def prefix_report(self) -> dict:
        """Host-side sharing stats (the reference's keys)."""
        c = self.prefix_counters
        total = c["hits"] + c["misses"]
        return {"enabled": self.prefix is not None,
                "hits": c["hits"], "misses": c["misses"],
                "hit_rate": (c["hits"] / total) if total else 0.0,
                "saved_tokens": c["saved_tokens"],
                "cow_forks": c["cow_forks"],
                "index_evictions": c["index_evictions"],
                "reclaimed_pages": c["reclaimed_pages"],
                "shared_pages": int(self.shared_pages),
                "index_pages": int(self.index_pages),
                "index_nodes": self.prefix.num_nodes if self.prefix is not None else 0}


# ---------------------------------------------------------------------------
# The ragged decode step: one position for EVERY slot, per-slot positions.
# ---------------------------------------------------------------------------


def _apply_rotary_rows(x: torch.Tensor, cos_b: torch.Tensor, sin_b: torch.Tensor,
                       rot: int) -> torch.Tensor:
    """``apply_rotary`` with a per-slot table row: x (B, 1, H, hd), cos/sin
    (B, rot) taken at each slot's own position."""
    c = cos_b[:, None, None, :].to(x.dtype)
    s = sin_b[:, None, None, :].to(x.dtype)
    if rot == x.shape[-1]:
        return x * c + _rotate_half(x) * s
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    return torch.cat([x_rot * c + _rotate_half(x_rot) * s, x_pass], dim=-1)


def _write_dest(page_table: torch.Tensor, lengths: torch.Tensor, ps: int) -> torch.Tensor:
    """Flat pool row each slot's new token lands in: its (length // ps)-th
    page at offset length % ps (inactive slots: the trash page's row 0;
    the page index is clamped into the table as the reference's gather
    clamps it)."""
    b, pps = page_table.shape
    ln = lengths.long()
    col = torch.clamp(ln // ps, max=pps - 1)
    return page_table.long()[torch.arange(b, device=ln.device), col] * ps + ln % ps


def _project_rows(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos_b, sin_b):
    q, k, v = project_qkv(cfg, lp, x)
    return (_apply_rotary_rows(q, cos_b, sin_b, cfg.rotary_dim),
            _apply_rotary_rows(k, cos_b, sin_b, cfg.rotary_dim), v)


def _attention_decode_paged(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos_b, sin_b,
                            k_pages: torch.Tensor, v_pages: torch.Tensor,
                            page_table: torch.Tensor, lengths: torch.Tensor):
    """The paged twin of ``transformer._attention_decode``: project the
    (B, 1, D) hidden, rotate each slot at its position, write the new K/V
    into each slot's current page in place, then attend over the slots'
    pages: K13 where :func:`paged_plan` admits the shape, else the gather
    path -> (out,)."""
    q, k, v = _project_rows(cfg, lp, x, cos_b, sin_b)
    pn, ps = k_pages.shape[:2]
    dest = _write_dest(page_table, lengths, ps)
    k_pages.view((pn * ps,) + tuple(k_pages.shape[2:])).index_copy_(
        0, dest, k[:, 0].to(k_pages.dtype))
    v_pages.view((pn * ps,) + tuple(v_pages.shape[2:])).index_copy_(
        0, dest, v[:, 0].to(v_pages.dtype))
    plan = paged_plan(q, k_pages, page_table)
    if plan is not None:
        out = paged_decode_attention(q, k_pages, v_pages, page_table, lengths + 1, plan=plan)
    else:  # the reference's gates refuse the shape: its gather path
        out = paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths + 1)
    return (project_out(lp, out),)


def _attention_decode_paged_quant(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos_b, sin_b,
                                  k_pages, v_pages, k_scale, v_scale,
                                  page_table: torch.Tensor, lengths: torch.Tensor,
                                  kv_codec: str):
    """The quantized-pool twin: the new K/V row quantizes on append (codes
    and its own per-row scales), then the attention dequantizes in
    registers (K14) or after the gather -> (out,)."""
    q, k, v = _project_rows(cfg, lp, x, cos_b, sin_b)
    pn, ps = k_pages.shape[:2]
    dest = _write_dest(page_table, lengths, ps)
    qk, sk = quantize_kv_rows(k[:, 0], kv_codec)
    qv, sv = quantize_kv_rows(v[:, 0], kv_codec)
    for arr, rows in ((k_pages, qk), (v_pages, qv), (k_scale, sk), (v_scale, sv)):
        arr.view((pn * ps,) + tuple(arr.shape[2:])).index_copy_(0, dest, rows)
    plan = paged_plan(q, k_pages, page_table, kv_codec)
    if plan is not None:
        out = paged_decode_attention_quant(q, k_pages, v_pages, k_scale, v_scale, page_table,
                                           lengths + 1, kv_codec=kv_codec, plan=plan)
    else:  # the reference's gates refuse the shape: its gather path
        out = paged_decode_attention_quant_plain(q, k_pages, v_pages, k_scale, v_scale,
                                                 page_table, lengths + 1, kv_codec=kv_codec)
    return (project_out(lp, out.to(x.dtype)),)


def block_decode_paged(cfg: ModelConfig, lp: dict, hidden: torch.Tensor, cos_b, sin_b,
                       k_pages: torch.Tensor, v_pages: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """The paged twin of ``transformer.block_decode`` for one layer: the same
    norms, residuals and MLP around the paged attention core; ``k_pages`` /
    ``v_pages`` are the layer's (num_pages, ps, KV, hd) pages, written in
    place -> the (B, 1, D) hidden."""
    return block_with(cfg, lp, hidden, lambda x: _attention_decode_paged(
        cfg, lp, x, cos_b, sin_b, k_pages, v_pages, page_table, lengths))[0]


def block_decode_paged_quant(cfg: ModelConfig, lp: dict, hidden: torch.Tensor, cos_b, sin_b,
                             k_pages, v_pages, k_scale, v_scale, page_table: torch.Tensor,
                             lengths: torch.Tensor, kv_codec: str) -> torch.Tensor:
    """:func:`block_decode_paged` over one layer of a quantized pool (codes
    and per-row scales, written in place)."""
    return block_with(cfg, lp, hidden, lambda x: _attention_decode_paged_quant(
        cfg, lp, x, cos_b, sin_b, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
        kv_codec))[0]


def run_layers_paged(cfg: ModelConfig, layers: list, hidden: torch.Tensor, pools: tuple,
                     page_table: torch.Tensor, lengths: torch.Tensor, kv_codec: str):
    """Every layer of ``layers`` (one dict each) over its pool slice
    (``pools``: the (L, num_pages, ps, ...) k, v[, k_scale, v_scale] arrays
    of those layers) for one ragged position -> the (B, 1, D) hidden. Each
    slot's RoPE row is taken at its own position, clamped into the span as
    the reference's gather clamps it."""
    span = page_table.shape[1] * pools[0].shape[2]
    cos, sin = precompute_rope(cfg, span, device=hidden.device)
    pos = torch.clamp(lengths.long(), max=span - 1)
    cos_b, sin_b = cos[pos], sin[pos]
    for idx, lp in enumerate(layers):
        layer = tuple(p[idx] for p in pools)
        if kv_codec == "fp":
            hidden = block_decode_paged(cfg, lp, hidden, cos_b, sin_b, *layer, page_table,
                                        lengths)
        else:
            hidden = block_decode_paged_quant(cfg, lp, hidden, cos_b, sin_b, *layer,
                                              page_table, lengths, kv_codec)
    return hidden


def _paged_step(cfg: ModelConfig, params: dict, pools: tuple, page_table: torch.Tensor,
                lengths: torch.Tensor, token_ids: torch.Tensor, compute_dtype,
                kv_codec: str) -> torch.Tensor:
    cfg.require_uniform("the paged decode step")
    params = _cast_params(params, compute_dtype)
    if token_ids.dim() == 1:
        token_ids = token_ids[:, None]
    hidden = embed(params, token_ids)  # (B, 1, D)
    hidden = run_layers_paged(cfg, params["layers"], hidden, pools, page_table, lengths,
                              kv_codec)
    return unembed(cfg, params, hidden)[:, -1]


@graph_contract("paged.decode_step", hops=0,
                in_place=lambda ctx: ctx.get("in_place_min", 2),
                launches=lambda ctx: {"paged_decode_attention": ctx["layers"]})
def paged_decode_step(cfg: ModelConfig, params: dict, pool_k: torch.Tensor,
                      pool_v: torch.Tensor, page_table: torch.Tensor, lengths: torch.Tensor,
                      token_ids: torch.Tensor, *, compute_dtype=None):
    """Append one position to EVERY slot of a paged pool in one pass.

    pool_k/pool_v: (L, num_pages, page_size, KV, hd), written in place;
    page_table (max_slots, pages_per_slot) and lengths (max_slots,) int32 on
    the pool's device; token_ids (max_slots,) (inactive slots pass any valid
    token; their writes land in the trash page). The RoPE row, the page
    write offset and the attention mask all index by each slot's own
    ``lengths[i]``. Returns (logits (max_slots, V) fp32, pool_k, pool_v)."""
    logits = _paged_step(cfg, params, (pool_k, pool_v), page_table, lengths, token_ids,
                         compute_dtype, "fp")
    return logits, pool_k, pool_v


@graph_contract("paged.decode_step_quant", hops=0,
                in_place=lambda ctx: ctx.get("in_place_min", 4),
                launches=lambda ctx: {"paged_decode_attention_quant": ctx["layers"]})
def paged_decode_step_quant(cfg: ModelConfig, params: dict, pool_k, pool_v,
                            pool_k_scale, pool_v_scale, page_table: torch.Tensor,
                            lengths: torch.Tensor, token_ids: torch.Tensor, *,
                            kv_codec: str, compute_dtype=None):
    """Quantized-pool twin of :func:`paged_decode_step`: the four
    :class:`QuantPagePool` arrays are written in place. Returns (logits,
    pool_k, pool_v, pool_k_scale, pool_v_scale)."""
    logits = _paged_step(cfg, params, (pool_k, pool_v, pool_k_scale, pool_v_scale),
                         page_table, lengths, token_ids, compute_dtype, kv_codec)
    return logits, pool_k, pool_v, pool_k_scale, pool_v_scale


__all__ = ["FREE", "SHARED", "PrefixCacheConfig", "PrefixIndex", "OutOfPages", "OutOfSlots",
           "KVTierMismatchError", "PagePool", "init_pool", "KVPageCodec", "KV_PAGE_CODECS",
           "resolve_kv_codec", "QuantPagePool", "init_quant_pool", "kv_page_bytes",
           "num_pages_for_bytes", "PagedKVCache", "block_decode_paged",
           "block_decode_paged_quant", "run_layers_paged", "paged_decode_step",
           "paged_decode_step_quant"]
