"""Graph-contract registry and the executed checkers behind it (the
reference's ``edgellm_tpu/lint/contracts.py``, the same contract names).

The stack's load-bearing properties (only quantized bytes cross a cut, the
hop plan moves exactly N payload leaves, no f64, no host sync on the hot
path, the KV caches updated in place, a disabled feature changes nothing)
are declared on the production entry points with :func:`graph_contract`.
The reference proves them on traced jaxprs; torch runs eagerly and has no
graph to trace, so every checker here is an EXECUTED check of the same
property: the lint drivers (``lint.entrypoints``) call the real entry point
once at lint geometry and read what it did.

Contract fields, the reference's in brackets:

- ``hops`` [collectives]: payload leaves copied across the cuts in the call,
  counted where they cross (:func:`~..codecs.wire_format.cross_cut`, armed
  by :func:`~..codecs.wire_format.wire_tap`): n_cuts x leaves, a fused hop
  one buffer a cut.
- ``wire_dtypes``: the dtype names allowed for every tensor that crosses.
- ``wire_bytes``: the exact bytes that cross.
- ``forbid``: ``"f64"`` (no float64 / complex128 tensor is produced by any
  op of the call: a ``TorchDispatchMode`` sees every aten op's outputs) and
  ``"host_sync"`` [host_callback] (on the card the call runs under
  ``torch.cuda.set_sync_debug_mode``; a CPU run cannot measure it and says
  so). ``host_syncs`` names the sites (``path:function`` inside the
  package) where an entry point syncs by design, each with its reason; a
  sync anywhere else is a finding.
- ``in_place`` [donate]: the minimum number of the call's KV-cache / page
  pool buffers that its outputs hold in the same storage
  (``untyped_storage().data_ptr()`` unchanged); on the card the call's
  allocator increment also stays under those buffers' bytes.
- ``launches`` (new, card only): the exact kernel launches of the call
  (the wrappers' ``.launches`` counters), declared from the codec registry
  and the layer count.

Every field may be a plain value or a ``callable(ctx)`` resolved at check
time: the driver supplies the measured facts (payload leaves, hop bytes,
layer and hop counts). A contract may be checked more than once (a forced
variant of one entry point carries its own name), so the decorator stacks.

The decorator adds nothing to a call: it records the spec and returns the
function unchanged.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import warnings
from collections import Counter
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

from .report import Finding

#: dtypes the "no f64" contract rejects: double precision anywhere in a
#: call means a silent promotion slipped in (the wire formats are
#: int4 / int8 / bf16, the compute fp32 or bf16)
F64_DTYPES = frozenset({"float64", "complex128"})

_DEFAULT_FORBID = ("f64", "host_sync")

#: what torch's sync debug mode says of a synchronizing call (its warning
#: under "warn", its error under "error")
SYNC_MESSAGE = "called a synchronizing CUDA operation"

#: the port's kernel wrappers by name (the names chip_smoke.py reports)
KERNEL_NAMES = (
    "causal_attention", "causal_attention_stats", "int4_encode", "int4_decode",
    "int8_affine_encode", "int8_affine_decode", "chan_int8_encode",
    "chan_int8_decode", "chan_int4_encode", "ternary_encode", "ternary_decode",
    "remote_hop", "paged_decode_attention", "paged_decode_attention_quant",
    "grouped_gemm_tf32x3", "gather_rows", "combine_rows")

#: a hop codec's kernels on the card: (encode, decode) wrapper names, one
#: launch each per payload encoded / decoded
HOP_KERNELS = {
    "int4_per_token": ("int4_encode", "int4_decode"),
    "int8_per_token": ("int8_affine_encode", "int8_affine_decode"),
    "int8_per_channel": ("chan_int8_encode", "chan_int8_decode"),
    "int4_per_channel": ("chan_int4_encode", "int4_decode"),
    "ternary_max": ("ternary_encode", "ternary_decode"),
}


@dataclasses.dataclass(frozen=True)
class GraphContract:
    """A declared contract for one executed entry point (see the module
    docstring). ``None`` (``0`` for ``in_place``) disables that check."""

    name: str
    fn: Optional[Callable] = None
    hops: Union[None, int, Callable] = None
    wire_dtypes: Union[None, frozenset, Callable] = None
    wire_bytes: Union[None, int, Callable] = None
    forbid: tuple = _DEFAULT_FORBID
    host_syncs: Tuple[Tuple[str, str], ...] = ()
    in_place: Union[int, Callable] = 0
    launches: Union[None, Mapping[str, int], Callable] = None

    def resolve(self, field: str, ctx: Optional[dict]) -> Any:
        val = getattr(self, field)
        return val(ctx or {}) if callable(val) else val


#: the in-code registry ``@graph_contract`` populates; the lint CLI's graph
#: layer iterates it (drivers in ``lint.entrypoints`` know how to build
#: example inputs for each name)
GRAPH_CONTRACTS: dict = {}


def graph_contract(name: Optional[str] = None, *,
                   hops: Union[None, int, Callable] = None,
                   wire_dtypes: Union[None, frozenset, Callable] = None,
                   wire_bytes: Union[None, int, Callable] = None,
                   forbid: tuple = _DEFAULT_FORBID,
                   host_syncs: Mapping[str, str] = None,
                   in_place: Union[int, Callable] = 0,
                   launches: Union[None, Mapping[str, int], Callable] = None
                   ) -> Callable:
    """Declare a contract on an entry point (decorator: it records the spec
    and returns the function unchanged).

    Usage::

        @graph_contract("split.forward",
                        hops=lambda ctx: ctx["hops"],
                        wire_bytes=lambda ctx: ctx["wire_bytes"])
        def forward(self, ...): ...

    ``host_syncs`` maps each site where the entry point syncs by design
    (``"codecs/faults.py:FaultyLink.hop"``) to its reason.
    """
    unknown = set(forbid) - {"f64", "host_sync"}
    if unknown:
        raise ValueError(f"unknown forbid entries {sorted(unknown)}; "
                         f"supported: 'f64', 'host_sync'")
    syncs = dict(host_syncs or {})
    bare = [site for site, why in syncs.items() if not str(why).strip()]
    if bare:
        raise ValueError(f"host_syncs {bare} need a reason each")

    def deco(fn: Callable) -> Callable:
        cname = name or fn.__qualname__
        GRAPH_CONTRACTS[cname] = GraphContract(
            name=cname, fn=fn, hops=hops, wire_dtypes=wire_dtypes,
            wire_bytes=wire_bytes, forbid=tuple(forbid),
            host_syncs=tuple(sorted(syncs.items())), in_place=in_place,
            launches=launches)
        return fn

    return deco


def hop_launches(codec_names, *, encodes: int = 1, decodes: int = 1) -> dict:
    """The hop kernels' launches of ``encodes`` encodes and ``decodes``
    decodes of every cut's codec (``codec_names``, one per cut; a twin's
    ``_pallas`` suffix is dropped): the codec registry's arithmetic."""
    out: Counter = Counter()
    for name in codec_names:
        enc, dec = HOP_KERNELS.get(name.removesuffix("_pallas"), (None, None))
        if enc is not None:
            out[enc] += encodes
            out[dec] += decodes
    return dict(out)


# ---------------------------------------------------------------------------
# what a call did
# ---------------------------------------------------------------------------


def _wrappers() -> dict:
    from ..codecs import codec_kernels as ck
    from ..codecs import fused_hop as fh
    from ..models import flash_attention as fa
    from ..models import gemm, moe

    mods = (fa, ck, fh, gemm, moe)
    return {name: getattr(next(m for m in mods if hasattr(m, name)), name)
            for name in KERNEL_NAMES}


def kernel_launches() -> Dict[str, int]:
    """Every kernel wrapper's launch counter, by name."""
    return {name: int(fn.launches) for name, fn in _wrappers().items()}


def launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    """The launches since ``before``, non-zero entries only."""
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def _tensors(obj) -> list:
    """Every tensor of a nested result, in a stable order."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for k in sorted(obj, key=str) for t in _tensors(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensors(x)]
    return []


def _op_recorder():
    """A ``TorchDispatchMode`` counting every aten op of a call by name and
    noting the ops whose outputs are double precision."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpRecorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops: Counter = Counter()
            self.f64: List[str] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func.overloadpacket)
            self.ops[name] += 1
            for t in _tensors(out):
                if str(t.dtype).removeprefix("torch.") in F64_DTYPES:
                    self.f64.append(name)
            return out

    return OpRecorder()


_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FUNC_INDEX: dict = {}


def _function_at(path: str, line: int) -> str:
    """``Class.method`` (or ``function``) of the def holding ``line``."""
    if path not in _FUNC_INDEX:
        spans = []
        with open(path, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)

        def walk(node, prefix):
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.ClassDef)):
                    qual = f"{prefix}{sub.name}"
                    if not isinstance(sub, ast.ClassDef):
                        spans.append((sub.lineno, sub.end_lineno, qual))
                    walk(sub, qual + ".")
                else:
                    walk(sub, prefix)

        walk(tree, "")
        _FUNC_INDEX[path] = spans
    inner = [s for s in _FUNC_INDEX[path] if s[0] <= line <= s[1]]
    return max(inner, key=lambda s: s[0])[2] if inner else "<module>"


def sync_site(path: str, line: int) -> Optional[str]:
    """``rel/path.py:qualname`` for a frame inside the package, else None."""
    path = os.path.abspath(path)
    if not path.startswith(_PKG_ROOT + os.sep):
        return None
    rel = os.path.relpath(path, _PKG_ROOT).replace(os.sep, "/")
    return f"{rel}:{_function_at(path, line)}"


def _traceback_site(exc: BaseException) -> str:
    """The innermost package frame of an exception's traceback."""
    tb, site = exc.__traceback__, None
    while tb is not None:
        got = sync_site(tb.tb_frame.f_code.co_filename, tb.tb_lineno)
        site = got or site
        tb = tb.tb_next
    return site or "<outside the package>"


@dataclasses.dataclass
class Execution:
    """What one executed call did."""

    result: Any = None
    error: Optional[BaseException] = None
    ops: Counter = dataclasses.field(default_factory=Counter)
    f64: List[str] = dataclasses.field(default_factory=list)
    wire: list = dataclasses.field(default_factory=list)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    syncs: List[str] = dataclasses.field(default_factory=list)
    sync_checked: bool = False
    increment: Optional[int] = None


def execute(call: Callable[[], Any], device, *, sync_mode: Optional[str] = None
            ) -> Execution:
    """Run ``call()`` once with every recorder armed: the op recorder, the
    wire tap, the launch counters and, on the card with ``sync_mode``
    ("error" or "warn"), torch's sync debug mode. A failing call is kept
    in ``error``; a sync under "error" lands there too."""
    import torch

    from ..codecs.wire_format import wire_tap

    on_card = torch.device(device).type == "cuda"
    ex = Execution()
    before = kernel_launches()
    recorder = _op_recorder()
    if on_card:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with wire_tap() as tap:
            if on_card and sync_mode:
                torch.cuda.set_sync_debug_mode(sync_mode)
                ex.sync_checked = True
            try:
                with recorder:
                    ex.result = call()
            except Exception as e:  # noqa: BLE001 - a failing call is a finding
                ex.error = e
            finally:
                if on_card and sync_mode:
                    torch.cuda.set_sync_debug_mode("default")
    if on_card:
        torch.cuda.synchronize(device)
        ex.increment = int(torch.cuda.max_memory_allocated(device)) - base
    ex.ops, ex.f64, ex.wire = recorder.ops, recorder.f64, tap
    ex.launches = launch_delta(before)
    ex.syncs = sorted({sync_site(w.filename, w.lineno) or
                       f"{w.filename}:{w.lineno}"
                       for w in caught if SYNC_MESSAGE in str(w.message)})
    if ex.error is not None and SYNC_MESSAGE in str(ex.error):
        ex.syncs.append(_traceback_site(ex.error))
    return ex


# ---------------------------------------------------------------------------
# the contract checker
# ---------------------------------------------------------------------------


def check_execution(contract: GraphContract, ex: Execution,
                    ctx: Optional[dict] = None, *, on_card: bool,
                    buffers: Optional[list] = None,
                    outputs: Optional[list] = None) -> Tuple[list, dict]:
    """Verify one contract against one :func:`execute` record.

    ``buffers`` are the call's in-place buffers as they were passed,
    ``outputs`` the buffers its result holds (for ``in_place``). Returns
    (findings, detail): the detail is what the report prints beside the
    declaration (hops, bytes, launches, the host-sync verdict)."""
    findings: list = []

    def fail(rule: str, msg: str) -> None:
        findings.append(Finding(layer="graph", rule=rule, where=contract.name,
                                line=0, message=msg))

    detail: dict = {"hops": len(ex.wire),
                    "wire_dtypes": sorted({d for d, _, _ in ex.wire}),
                    "wire_bytes": sum(b for _, _, b in ex.wire),
                    "launches": dict(ex.launches)}
    if ex.error is not None:
        if ex.syncs:  # sync debug mode "error" stopped the call at a sync
            detail["host_sync"] = {"checked": True, "syncs": ex.syncs}
            fail("GC-host-sync",
                 f"host sync at {ex.syncs} inside the call "
                 f"(torch.cuda.set_sync_debug_mode('error')): it stalls the "
                 f"card on the hot path — remove it or declare the site with "
                 f"its reason (host_syncs)")
        else:
            fail("GC-run", f"entry point failed to run: "
                           f"{type(ex.error).__name__}: {ex.error}")
        return findings, detail

    if "f64" in contract.forbid and ex.f64:
        fail("GC-f64",
             f"{len(ex.f64)} double-precision output(s) from "
             f"{sorted(set(ex.f64))}; a silent f32->f64 promotion slipped "
             f"into the call")
    if "host_sync" in contract.forbid:
        if ex.sync_checked:
            allowed = {site for site, _ in contract.host_syncs}
            bad = sorted(set(ex.syncs) - allowed)
            detail["host_sync"] = {"checked": True, "syncs": ex.syncs,
                                   "declared": sorted(allowed)}
            if bad:
                fail("GC-host-sync",
                     f"host sync(s) at {bad} inside the call "
                     f"(torch.cuda.set_sync_debug_mode); each one stalls the "
                     f"card on the hot path — remove it or declare the site "
                     f"with its reason (host_syncs)")
        else:
            detail["host_sync"] = {"checked": False}

    want = contract.resolve("hops", ctx)
    if want is not None and len(ex.wire) != int(want):
        fail("GC-hops",
             f"{len(ex.wire)} payload leaves crossed the cuts, the contract "
             f"declares {int(want)} — a copy across a cut was silently "
             f"added or removed")
    dtypes = contract.resolve("wire_dtypes", ctx)
    if dtypes is not None:
        bad = sorted({d for d, _, _ in ex.wire} - frozenset(dtypes))
        if bad:
            fail("GC-wire-dtype",
                 f"dtypes {bad} cross the boundary hop but the codec's "
                 f"declared wire format is {sorted(dtypes)} — unquantized "
                 f"data is leaking across the cut")
    nbytes = contract.resolve("wire_bytes", ctx)
    if nbytes is not None:
        total = sum(b for _, _, b in ex.wire)
        if total != int(nbytes):
            fail("GC-wire-bytes",
                 f"boundary hops move {total} bytes, codec declares "
                 f"{int(nbytes)} — payload width drifted from the wire "
                 f"contract")

    need = int(contract.resolve("in_place", ctx) or 0)
    if need:
        kept = {t.untyped_storage().data_ptr() for t in buffers or ()}
        aliased = sum(1 for t in outputs or ()
                      if t.untyped_storage().data_ptr() in kept)
        detail["in_place"] = {"aliased": aliased, "required": need}
        if aliased < need:
            fail("GC-in-place",
                 f"only {aliased} of the call's KV/pool buffer(s) keep their "
                 f"storage, the contract requires >= {need} — the cache is "
                 f"being copied every step instead of updated in place")
        if on_card and ex.increment is not None:
            pool_bytes = sum(t.numel() * t.element_size() for t in buffers or ())
            detail["in_place"].update(increment=ex.increment,
                                      buffer_bytes=pool_bytes)
            if ex.increment >= pool_bytes:
                fail("GC-in-place",
                     f"the call allocated {ex.increment} bytes, not under its "
                     f"KV/pool buffers' {pool_bytes}: a copy of the cache "
                     f"was made")

    declared = contract.resolve("launches", ctx)
    if declared is not None:
        want_l = {k: int(v) for k, v in dict(declared).items() if v}
        detail["launches_declared"] = want_l
        if on_card and ex.launches != want_l:
            zero = sorted(k for k in want_l if not ex.launches.get(k))
            fail("GC-launches",
                 f"kernel launches {ex.launches} != declared {want_l}"
                 + (f"; {zero} never launched" if zero else ""))
    return findings, detail


def _same_values(a: list, b: list) -> bool:
    import torch

    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.detach().cpu(), y.detach().cpu())
        for x, y in zip(a, b))


def _same_shapes(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape for x, y in zip(a, b))


def check_identity(name: str, run_a: Callable[[], Any], run_b: Callable[[], Any],
                   device, *, what: str = "disabled-config call",
                   values: bool = True) -> list:
    """The executed disabled-config-identity checker: both builds run on the
    same inputs and must launch the same kernels the same number of times,
    run the same aten ops the same number of times, and (``values``) give
    bit-equal outputs and caches; without ``values`` (two calls over
    different live data) their outputs' shapes and dtypes. Returns [] or
    one Finding."""
    def fail(msg: str) -> list:
        return [Finding(layer="graph", rule="GC-identity", where=name, line=0,
                        message=msg)]

    ex_a, ex_b = execute(run_a, device), execute(run_b, device)
    for ex in (ex_a, ex_b):
        if ex.error is not None:
            return fail(f"identity check failed to run: "
                        f"{type(ex.error).__name__}: {ex.error}")
    if ex_a.launches != ex_b.launches:
        return fail(f"{what} launches {ex_a.launches}, the pre-feature call "
                    f"{ex_b.launches}: the disabled feature adds kernel work")
    if ex_a.ops != ex_b.ops:
        diff = {k: (ex_a.ops[k], ex_b.ops[k])
                for k in set(ex_a.ops) | set(ex_b.ops)
                if ex_a.ops[k] != ex_b.ops[k]}
        return fail(f"{what} runs other aten ops than the pre-feature call "
                    f"(op: (this, pre-feature)) {dict(sorted(diff.items()))}: "
                    f"the disabled feature leaks machinery into the call")
    ta, tb = _tensors(ex_a.result), _tensors(ex_b.result)
    same = _same_values(ta, tb) if values else _same_shapes(ta, tb)
    if not same:
        return fail(f"{what} is NOT identical to the pre-feature call: its "
                    f"outputs differ ({'values' if values else 'shapes'})")
    return []
