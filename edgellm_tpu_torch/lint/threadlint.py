"""threadlint: lock-discipline static analysis for the host serve plane (the
reference's ``edgellm_tpu/lint/threadlint.py`` over the port's package).

Second graphlint layer (beside the AST rules and the executed graph
contracts), covering the threads.  The serve plane
(ServeFront.submit, ContinuousBatcher, the obs HTTP daemon scraping
/metrics mid-decode, the flight-recorder ring) rests on hand-placed
``threading.Lock`` sites; these rules make that discipline checkable.

Rule family EG1xx ("thread" layer):

- **EG101** — write to a guarded field outside the owning lock.  A class
  declares its contract with ``@guarded_by("_lock", fields=[...])``
  (``edgellm_tpu_torch.utils.concurrency``), or is auto-discovered: any field
  a class writes under ``with self.<lock>`` is inferred guarded, and
  every *other* write to it must also hold the lock.  ``__init__`` and
  ``*_locked`` helper methods (caller-holds-lock convention) are exempt.
- **EG102** — inconsistent multi-lock acquisition order: acquiring two
  locks of the same shape (``self._lock`` then ``other._lock``) in
  source order deadlocks when two instances merge into each other
  concurrently (the ``Histogram.merge_from`` bug).  Also fires on
  re-acquiring a held non-reentrant lock, and on cross-class A→B / B→A
  order cycles seen anywhere in the linted set.  The fix —
  ``with acquire_in_order(a._lock, b._lock):`` — is recognised as one
  atomic, globally-ordered acquisition and never flagged.
- **EG103** — blocking call while holding a lock: a call that waits for
  the card (``torch.cuda.synchronize``, ``Event.synchronize()``, and the
  device-to-host copies ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()`` and ``.to("cpu")``), file I/O (``open``/``os.replace``/
  fsync), ``time.sleep``, subprocess/socket/HTTP work.  Critical sections on the
  scrape path must be O(memcpy); stage the slow work outside the lock
  (see ``FlightRecorder.dump``).
- **EG104** — ``contextvars`` token discipline: a token returned by
  ``cv.set(...)`` must be ``cv.reset(token)`` in the same frame that set
  it (the TraceContext bind/unbind invariant).  Storing the token on
  ``self``, discarding it, resetting a foreign token, or leaking it
  without a reset all fire.

Like the other layers, ``# graphlint: disable=EG10x`` on the offending
line suppresses a finding.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .ast_rules import _suppressed_lines, iter_package_files  # noqa: F401
from .report import Finding

LAYER = "thread"

#: spellings that create a lock object
_LOCK_FACTORIES = {"Lock", "RLock", "threading.Lock", "threading.RLock"}
#: ``with <helper>(lockA, lockB):`` — atomic globally-ordered acquisition
_ORDERED_HELPERS = {"acquire_in_order", "ordered_locks"}
#: method names exempt from EG101 (single-threaded construction, or the
#: ``*_locked`` caller-holds-lock convention)
_EXEMPT_METHODS = {"__init__", "__post_init__", "__new__", "__del__",
                   "__getstate__", "__setstate__", "__copy__", "__deepcopy__"}
#: container mutators: ``self.field.append(x)`` is a write to ``field``
_MUTATORS = {"append", "extend", "insert", "update", "add", "pop", "popitem",
             "remove", "clear", "setdefault", "discard", "appendleft",
             "popleft", "sort", "reverse"}
_HEAP_FNS = {"heappush", "heappop", "heappushpop", "heapreplace", "heapify"}

# EG103 vocabulary ----------------------------------------------------------
_BLOCKING_PREFIXES = ("subprocess.", "requests.", "urllib.", "socket.",
                      "shutil.", "http.")
_BLOCKING_EXACT = {"time.sleep", "os.replace", "os.fsync", "os.makedirs",
                   "os.mkdir", "os.rename", "os.remove", "os.unlink",
                   "os.system", "os.popen", "torch.cuda.synchronize"}
#: method calls that block: an event's or a stream's wait for the card,
#: the server loop, an HTTP request
_BLOCKING_ATTRS = {"synchronize", "serve_forever", "urlopen"}
#: argument-free tensor methods that copy to the host, waiting for the card
_HOST_COPY_ATTRS = {"item", "cpu", "tolist", "numpy"}


def _to_host(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device("cpu"))``:
    a device-to-host copy, which waits for the card."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    args = list(call.args) + [kw.value for kw in call.keywords
                              if kw.arg == "device"]
    for a in args:
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
        if (isinstance(a, ast.Call) and _dotted(a.func) == "torch.device"
                and a.args and isinstance(a.args[0], ast.Constant)
                and a.args[0].value == "cpu"):
            return True
    return False


def _dotted(expr: ast.expr) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    node = expr
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _lockish(attr: str) -> bool:
    return "lock" in attr.lower()


def _self_root(expr: ast.expr) -> Optional[str]:
    """Field name F for stores through ``self.F`` / ``self.F[...]`` /
    ``self.F.x`` — the attribute hanging directly off ``self``."""
    if isinstance(expr, ast.Attribute):
        if isinstance(expr.value, ast.Name) and expr.value.id == "self":
            return expr.attr
        return _self_root(expr.value)
    if isinstance(expr, ast.Subscript):
        return _self_root(expr.value)
    if isinstance(expr, (ast.Starred,)):
        return _self_root(expr.value)
    return None


def _written_fields(stmt: ast.stmt) -> List[Tuple[str, int]]:
    """(field, line) for every ``self.<field>`` write this statement makes."""
    out: List[Tuple[str, int]] = []

    def add_target(t: ast.expr) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for elt in t.elts:
                add_target(elt)
            return
        root = _self_root(t)
        if root is not None:
            out.append((root, t.lineno))

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            add_target(t)
    elif isinstance(stmt, ast.AugAssign):
        add_target(stmt.target)
    elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        add_target(stmt.target)
    elif isinstance(stmt, ast.Delete):
        for t in stmt.targets:
            add_target(t)
    return out


def _call_writes(call: ast.Call) -> List[Tuple[str, int]]:
    """``self.<field>`` writes made by one call expression, wherever it
    sits (statement, assign value, condition): container mutators like
    ``self.q.append(x)`` and the in-place heapq free functions."""
    out: List[Tuple[str, int]] = []
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
        root = _self_root(f.value)
        if root is not None:
            out.append((root, call.lineno))
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    if name in _HEAP_FNS and call.args:
        root = _self_root(call.args[0])
        if root is not None:
            out.append((root, call.lineno))
    return out


# -- per-class contracts ----------------------------------------------------


@dataclass
class _ClassInfo:
    name: str
    node: ast.ClassDef
    lock_attrs: Set[str] = field(default_factory=set)
    declared_lock: Optional[str] = None
    declared_fields: Set[str] = field(default_factory=set)
    guarded: Set[str] = field(default_factory=set)


def _parse_guarded_by(dec: ast.expr) -> Optional[Tuple[str, Set[str]]]:
    if not isinstance(dec, ast.Call):
        return None
    name = dec.func.attr if isinstance(dec.func, ast.Attribute) else (
        dec.func.id if isinstance(dec.func, ast.Name) else None)
    if name != "guarded_by" or not dec.args:
        return None
    lock = dec.args[0]
    if not (isinstance(lock, ast.Constant) and isinstance(lock.value, str)):
        return None
    fields: Set[str] = set()
    for kw in dec.keywords:
        if kw.arg == "fields" and isinstance(kw.value, (ast.List, ast.Tuple)):
            for elt in kw.value.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    fields.add(elt.value)
    return lock.value, fields


def _collect_class(node: ast.ClassDef) -> _ClassInfo:
    info = _ClassInfo(name=node.name, node=node)
    for dec in node.decorator_list:
        parsed = _parse_guarded_by(dec)
        if parsed:
            info.declared_lock, info.declared_fields = parsed
    for sub in ast.walk(node):
        if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call):
            dotted = _dotted(sub.value.func)
            if dotted in _LOCK_FACTORIES:
                for t in sub.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        info.lock_attrs.add(t.attr)
    if info.declared_lock:
        info.lock_attrs.add(info.declared_lock)
    return info


# -- lock-region walker -----------------------------------------------------


@dataclass
class _Acq:
    """One ``with``-item lock acquisition (possibly several locks when
    taken through an ordered helper)."""
    tokens: List[Tuple[str, str]]        # (owner class | "?" | "<module>", attr)
    expr_keys: List[str]                 # source spelling per token
    guards_self: bool
    ordered: bool
    line: int
    display: str


@dataclass
class _FileState:
    path: str
    emit: "object"                       # callable(rule, line, msg)
    edges: List[Tuple[Tuple[str, str], Tuple[str, str], int]] = \
        field(default_factory=list)


def _ann_name(ann: Optional[ast.expr]) -> Optional[str]:
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.strip('"\'')
    if isinstance(ann, ast.Attribute):
        return ann.attr
    return None


class _FnWalker:
    """Walks one function body tracking the held-lock stack; fires
    EG101 (check mode) / collects guarded fields (collect mode), EG102
    inline, and EG103."""

    def __init__(self, st: _FileState, cls: Optional[_ClassInfo],
                 fn: ast.AST, collect_only: bool,
                 discovered: Optional[Set[str]] = None) -> None:
        self.st = st
        self.cls = cls
        self.fn = fn
        self.collect_only = collect_only
        self.discovered = discovered if discovered is not None else set()
        self.stack: List[_Acq] = []
        self.param_types: Dict[str, str] = {}
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = fn.args
            for a in (list(args.posonlyargs) + list(args.args)
                      + list(args.kwonlyargs)):
                t = _ann_name(a.annotation)
                if t:
                    self.param_types[a.arg] = t

    # lock classification ---------------------------------------------------

    def _owner_of(self, base: ast.expr) -> str:
        if isinstance(base, ast.Name):
            if base.id == "self":
                return self.cls.name if self.cls else "?"
            return self.param_types.get(base.id, "?")
        return "?"

    def _classify(self, expr: ast.expr) -> Optional[_Acq]:
        # with acquire_in_order(a._lock, b._lock):
        if isinstance(expr, ast.Call):
            name = expr.func.attr if isinstance(expr.func, ast.Attribute) \
                else (expr.func.id if isinstance(expr.func, ast.Name) else None)
            if name in _ORDERED_HELPERS:
                tokens, keys, guards_self = [], [], False
                for arg in expr.args:
                    if isinstance(arg, ast.Attribute) and _lockish(arg.attr):
                        tokens.append((self._owner_of(arg.value), arg.attr))
                        keys.append(ast.unparse(arg))
                        if (isinstance(arg.value, ast.Name)
                                and arg.value.id == "self"):
                            guards_self = True
                return _Acq(tokens=tokens, expr_keys=keys,
                            guards_self=guards_self, ordered=True,
                            line=expr.lineno, display=ast.unparse(expr))
            return None
        # with self._lock:   /   with other._lock:
        if isinstance(expr, ast.Attribute):
            known = self.cls.lock_attrs if self.cls else set()
            if expr.attr in known or _lockish(expr.attr):
                owner = self._owner_of(expr.value)
                guards_self = (isinstance(expr.value, ast.Name)
                               and expr.value.id == "self")
                return _Acq(tokens=[(owner, expr.attr)],
                            expr_keys=[ast.unparse(expr)],
                            guards_self=guards_self, ordered=False,
                            line=expr.lineno, display=ast.unparse(expr))
        # with _lock:   (module-level lock)
        if isinstance(expr, ast.Name) and _lockish(expr.id):
            return _Acq(tokens=[("<module>", expr.id)], expr_keys=[expr.id],
                        guards_self=False, ordered=False,
                        line=expr.lineno, display=expr.id)
        return None

    def _check_order(self, acq: _Acq) -> None:
        """EG102 inline + record cross-class edges."""
        for held in self.stack:
            for (h_owner, h_attr), h_key in zip(held.tokens, held.expr_keys):
                for (n_owner, n_attr), n_key in zip(acq.tokens, acq.expr_keys):
                    if not acq.ordered and n_key == h_key:
                        self.st.emit(
                            "EG102", acq.line,
                            f"re-acquiring `{n_key}` while already holding it "
                            f"(line {held.line}); threading.Lock is not "
                            f"reentrant — this self-deadlocks")
                        continue
                    same_shape = (n_attr == h_attr
                                  and (n_owner == h_owner
                                       or "?" in (n_owner, h_owner)))
                    if not acq.ordered and same_shape:
                        self.st.emit(
                            "EG102", acq.line,
                            f"acquiring `{n_key}` while holding `{h_key}` "
                            f"(line {held.line}): two instances of the same "
                            f"lock taken in source order deadlock when the "
                            f"roles reverse concurrently; use "
                            f"acquire_in_order({h_key}, {n_key})")
                        continue
                    if ("?" not in (n_owner, h_owner)
                            and (h_owner, h_attr) != (n_owner, n_attr)):
                        self.st.edges.append(
                            ((h_owner, h_attr), (n_owner, n_attr), acq.line))

    # traversal -------------------------------------------------------------

    def _held_self(self) -> bool:
        return any(a.guards_self for a in self.stack)

    def _innermost(self) -> str:
        return self.stack[-1].display if self.stack else "?"

    def _check_write(self, fieldname: str, line: int) -> None:
        if self.cls is None:
            return
        if fieldname in self.cls.lock_attrs:
            return
        if self.collect_only:
            if self._held_self():
                self.discovered.add(fieldname)
            return
        if fieldname in self.cls.guarded and not self._held_self():
            lock = self.cls.declared_lock or next(
                iter(sorted(self.cls.lock_attrs)), "_lock")
            self.st.emit(
                "EG101", line,
                f"write to guarded field `{self.cls.name}.{fieldname}` "
                f"outside `with self.{lock}`; every other writer holds the "
                f"lock, so this write can race or be torn")

    def _check_blocking(self, call: ast.Call) -> None:
        if self.collect_only or not self.stack:
            return
        dotted = _dotted(call.func)
        label: Optional[str] = None
        if dotted is not None:
            if dotted in _BLOCKING_EXACT:
                label = dotted
            elif dotted.startswith(_BLOCKING_PREFIXES):
                label = dotted
            elif dotted == "open":
                label = "open"
        if label is None and isinstance(call.func, ast.Attribute) and (
                call.func.attr in _BLOCKING_ATTRS
                or (call.func.attr in _HOST_COPY_ATTRS and not call.args)):
            label = f".{call.func.attr}"
        if label is None and _to_host(call):
            label = '.to("cpu")'
        if label is not None:
            self.st.emit(
                "EG103", call.lineno,
                f"blocking call `{label}(...)` while holding "
                f"`{self._innermost()}`; critical sections on the serve/"
                f"scrape path must stay O(memcpy) — stage the slow work "
                f"outside the lock")

    def walk(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        for f, line in _written_fields(stmt):
            self._check_write(f, line)
        for call in self._calls_in(stmt):
            self._check_blocking(call)
            for f, line in _call_writes(call):
                self._check_write(f, line)

        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in stmt.items:
                acq = self._classify(item.context_expr)
                if acq is not None:
                    self._check_order(acq)
                    self.stack.append(acq)
                    pushed += 1
            self.walk(stmt.body)
            for _ in range(pushed):
                self.stack.pop()
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: analyzed with the lock state at its def site
            self.walk(stmt.body)
            return
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, ast.stmt):
                self._stmt(sub)
            elif isinstance(sub, ast.ExceptHandler):
                self.walk(sub.body)

    def _calls_in(self, stmt: ast.stmt) -> Iterable[ast.Call]:
        """Calls made directly by this statement (not inside nested defs
        or nested ``with`` bodies, which get their own visit)."""
        skip_bodies = isinstance(stmt, (ast.With, ast.AsyncWith, ast.If,
                                        ast.For, ast.AsyncFor, ast.While,
                                        ast.Try, ast.FunctionDef,
                                        ast.AsyncFunctionDef))
        roots: List[ast.AST] = []
        if skip_bodies:
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                roots.extend(i.context_expr for i in stmt.items)
            elif isinstance(stmt, (ast.If, ast.While)):
                roots.append(stmt.test)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                roots.append(stmt.iter)
            # Try: nothing at statement level
        else:
            roots.append(stmt)
        for root in roots:
            for node in ast.walk(root):
                if isinstance(node, ast.Call):
                    yield node


# -- EG104: contextvars token discipline ------------------------------------


def _contextvar_names(tree: ast.Module) -> Set[str]:
    names: Set[str] = set()
    for stmt in tree.body:
        value = None
        targets: List[ast.expr] = []
        if isinstance(stmt, ast.Assign):
            value, targets = stmt.value, stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            value, targets = stmt.value, [stmt.target]
        if not isinstance(value, ast.Call):
            continue
        dotted = _dotted(value.func)
        if dotted in ("contextvars.ContextVar", "ContextVar"):
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def _frame_stmts(fn: ast.AST) -> Iterable[ast.stmt]:
    """Statements of this function frame, not descending into nested
    function/class frames (a token crossing frames is exactly the bug)."""
    stack: List[ast.stmt] = list(getattr(fn, "body", []))
    while stack:
        stmt = stack.pop()
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                stack.append(child)
            elif isinstance(child, ast.ExceptHandler):
                stack.extend(child.body)


def _cv_call(node: ast.expr, cv_names: Set[str],
             method: str) -> Optional[ast.Call]:
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == method):
        base = node.func.value
        base_name = base.attr if isinstance(base, ast.Attribute) else (
            base.id if isinstance(base, ast.Name) else None)
        if base_name in cv_names:
            return node
    return None


def _check_contextvars(tree: ast.Module, emit) -> None:
    cv_names = _contextvar_names(tree)
    if not cv_names:
        return
    for fn in [n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        tokens: Dict[str, int] = {}          # local token name -> set line
        handled: Set[int] = set()            # id() of set-calls accounted for
        resets_of: Set[str] = set()
        stmts = list(_frame_stmts(fn))
        for stmt in stmts:
            if isinstance(stmt, ast.Assign):
                call = _cv_call(stmt.value, cv_names, "set")
                if call is not None:
                    handled.add(id(call))
                    if (len(stmt.targets) == 1
                            and isinstance(stmt.targets[0], ast.Name)):
                        tokens[stmt.targets[0].id] = stmt.lineno
                    else:
                        emit("EG104", stmt.lineno,
                             "contextvar token stored outside this frame "
                             "(e.g. on self); tokens must be reset by the "
                             "frame that called .set() — a foreign-frame "
                             "reset raises or silently corrupts the context")
            elif isinstance(stmt, ast.Expr):
                call = _cv_call(stmt.value, cv_names, "set")
                if call is not None:
                    handled.add(id(call))
                    emit("EG104", stmt.lineno,
                         "contextvar .set() token discarded; without the "
                         "token this frame can never .reset(), leaking the "
                         "binding into unrelated requests on this thread")
        for stmt in stmts:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.expr):
                    continue
                call = _cv_call(sub, cv_names, "set")
                if call is not None and id(call) not in handled:
                    handled.add(id(call))
                    emit("EG104", call.lineno,
                         "contextvar .set() in an expression position; bind "
                         "the token to a local and reset it in a finally")
                rcall = _cv_call(sub, cv_names, "reset")
                if rcall is not None:
                    arg = rcall.args[0] if rcall.args else None
                    if isinstance(arg, ast.Name) and arg.id in tokens:
                        resets_of.add(arg.id)
                    else:
                        emit("EG104", rcall.lineno,
                             "contextvar .reset() with a token not created "
                             "in this frame; set and reset must pair within "
                             "one frame (the TraceContext bind/unbind "
                             "invariant)")
        for name, line in tokens.items():
            if name not in resets_of:
                emit("EG104", line,
                     f"contextvar token `{name}` is never reset in the frame "
                     f"that set it; wrap the body in try/finally and call "
                     f".reset({name})")


# -- driver -----------------------------------------------------------------


def _analyze(tree: ast.Module, st: _FileState) -> None:
    for cls_node in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        info = _collect_class(cls_node)
        if not info.lock_attrs:
            continue
        methods = [m for m in cls_node.body
                   if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))]
        discovered: Set[str] = set()
        for m in methods:
            w = _FnWalker(st, info, m, collect_only=True,
                          discovered=discovered)
            w.walk(m.body)
        info.guarded = discovered | info.declared_fields
        for m in methods:
            if m.name in _EXEMPT_METHODS or m.name.endswith("_locked"):
                # still track EG102/EG103 inside, but skip EG101 via
                # collect_only=False with guarded cleared for this method
                saved = info.guarded
                info.guarded = set()
                w = _FnWalker(st, info, m, collect_only=False)
                w.walk(m.body)
                info.guarded = saved
                continue
            w = _FnWalker(st, info, m, collect_only=False)
            w.walk(m.body)
    # module-level functions: EG102/EG103 against module locks
    for fn in tree.body:
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            w = _FnWalker(st, None, fn, collect_only=False)
            w.walk(fn.body)
    _check_contextvars(tree, st.emit)


def _cycle_findings(
        edges: List[Tuple[Tuple[str, str], Tuple[str, str], str, int]],
) -> List[Finding]:
    """Global pass: A→B at one site and B→A at another is an order cycle."""
    by_pair: Dict[Tuple[Tuple[str, str], Tuple[str, str]],
                  List[Tuple[str, int]]] = {}
    for a, b, path, line in edges:
        by_pair.setdefault((a, b), []).append((path, line))
    out: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for (a, b), sites in by_pair.items():
        rev = by_pair.get((b, a))
        if not rev or a >= b:  # report each unordered pair once, from a<b
            continue
        for path, line in sites + rev:
            if (path, line) in seen:
                continue
            seen.add((path, line))
            out.append(Finding(
                layer=LAYER, rule="EG102", where=path, line=line,
                message=(f"lock-order cycle: `{a[0]}.{a[1]}` -> "
                         f"`{b[0]}.{b[1]}` here, but the reverse order is "
                         f"taken elsewhere in the package; pick one global "
                         f"order or use acquire_in_order")))
    return out


def lint_source(source: str, path: str) -> List[Finding]:
    """All thread-layer findings for one module (including the local
    lock-order cycle pass)."""
    findings, edges = _lint_one(source, path)
    findings.extend(_cycle_findings(edges))
    return sort_unique(findings)


def _lint_one(
        source: str, path: str,
) -> Tuple[List[Finding],
           List[Tuple[Tuple[str, str], Tuple[str, str], str, int]]]:
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return ([Finding(layer=LAYER, rule="EG000", where=path,
                         line=e.lineno or 0,
                         message=f"syntax error: {e.msg}")], [])
    suppressed = _suppressed_lines(source)
    raw: List[Finding] = []

    def emit(rule: str, line: int, message: str) -> None:
        sup = suppressed.get(line, ...)
        if sup is None or (sup is not ... and rule in sup):
            return
        raw.append(Finding(layer=LAYER, rule=rule, where=path, line=line,
                           message=message))

    st = _FileState(path=path, emit=emit)
    _analyze(tree, st)
    edges = [(a, b, path, line) for a, b, line in st.edges
             if not _edge_suppressed(suppressed, line)]
    return raw, edges


def _edge_suppressed(suppressed: Dict[int, Optional[Set[str]]],
                     line: int) -> bool:
    if line not in suppressed:
        return False
    sup = suppressed[line]
    return sup is None or "EG102" in sup


def sort_unique(findings: List[Finding]) -> List[Finding]:
    seen: Set[Tuple[str, str, int, str]] = set()
    out: List[Finding] = []
    for f in sorted(findings, key=lambda f: (f.where, f.line, f.rule)):
        key = (f.rule, f.where, f.line, f.message)
        if key in seen:
            continue
        seen.add(key)
        out.append(f)
    return out


def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        return lint_source(f.read(), path)


def lint_files(paths: Iterable[str]) -> List[Finding]:
    """Thread-layer findings across ``paths``, with the lock-order cycle
    pass run over the whole set (cross-file A→B / B→A is visible here)."""
    findings: List[Finding] = []
    edges: List[Tuple[Tuple[str, str], Tuple[str, str], str, int]] = []
    for p in paths:
        try:
            with open(p, "r", encoding="utf-8") as f:
                source = f.read()
        except OSError:
            continue
        fs, es = _lint_one(source, p)
        findings.extend(fs)
        edges.extend(es)
    findings.extend(_cycle_findings(edges))
    return sort_unique(findings)


def lint_package(root: Optional[str] = None) -> List[Finding]:
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return lint_files(iter_package_files(root))
