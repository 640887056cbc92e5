"""Layer 1: AST lint (the reference's ``edgellm_tpu/lint/ast_rules.py``, the
rules that mean something under torch).

Rules (stable ids, suppress per line with ``# graphlint: disable=EG00x`` or
``# graphlint: disable`` for all):

EG005  A per-token host sync inside a decode/generate loop: a device-to-host
       copy (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
       ``.to("cpu")``), ``torch.cuda.synchronize``, or ``float()`` /
       ``int()`` / ``bool()`` of a tensor expression. Each one waits for the
       card once a token. A value already on the host is not a finding: a
       name bound from a host copy (``toks_host = t.cpu().numpy()`` before
       the loop), numpy math, and plain Python values (the reference's
       ``_is_host_numpy_expr``, widened to torch's host copies).
EG007  A literal metric name (the first argument of a registry's
       ``counter`` / ``gauge`` / ``histogram``, or of a direct ``Counter`` /
       ``Gauge`` / ``Histogram`` construction) or span name (the first
       argument of ``span`` / ``obs_span``) that is not in the registered
       vocabulary (the port's ``obs/names.py``): a typo'd name silently
       creates a series no dashboard ever scrapes. f-string names lint as
       wildcard patterns against the registered templates; fully dynamic
       names (a variable) are out of scope.

The reference's EG001-EG004 and EG006 police tracing under ``jax.jit``
(traced branches, host I/O at trace time, numpy on tracers, missing
``static_argnames``, container mutation at trace time). Eager torch has no
trace time, so they have no counterpart here.

A tensor expression is one that calls into ``torch`` (``torch.log(x)``),
calls a tensor method (``x.argmax()``, ``x.sum()``), or reads a name the
function bound from one; tensor metadata (``.shape``, ``.size()``,
``.numel()``, ``.dtype``) is host data.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .report import Finding

# -- rule vocabulary --------------------------------------------------------

#: numpy namespaces: math through them runs on the host
NUMPY_ALIASES = frozenset({"np", "numpy", "onp"})

#: argument-free tensor methods that copy to the host (a sync each)
HOST_COPY_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

#: tensor methods whose result is a tensor (on the tensor's device)
TENSOR_METHODS = frozenset({
    "argmax", "argmin", "max", "min", "sum", "mean", "exp", "log", "softmax",
    "log_softmax", "logsumexp", "topk", "sort", "argsort", "norm", "abs",
    "float", "double", "half", "bfloat16", "to", "cuda", "clone", "detach",
    "reshape", "view", "squeeze", "unsqueeze", "flatten", "any", "all",
    "eq", "ne", "gt", "lt", "ge", "le", "masked_fill", "gather",
    "index_select", "cumsum", "prod", "sqrt", "round", "clamp", "sign",
    "isfinite", "isnan", "multinomial",
})

#: tensor metadata: host values that never wait for the card
META_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda",
                        "requires_grad", "layout"})
META_METHODS = frozenset({"size", "numel", "dim", "element_size", "stride",
                          "is_contiguous", "nelement", "data_ptr",
                          "get_device"})
#: torch functions that return host objects, not tensors
TORCH_HOST_FNS = frozenset({
    "torch.device", "torch.dtype", "torch.Size", "torch.is_tensor",
    "torch.promote_types", "torch.get_default_dtype", "torch.finfo",
    "torch.iinfo", "torch.is_floating_point", "torch.numel",
    "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.current_device", "torch.cuda.get_device_name",
})

#: EG007 vocabulary: registry factory methods, direct metric constructors,
#: and the span entry points whose first argument is THE name
METRIC_FACTORY_METHODS = frozenset({"counter", "gauge", "histogram"})
METRIC_CLASSES = frozenset({"Counter", "Gauge", "Histogram"})
SPAN_CALLEES = frozenset({"span", "obs_span"})

_DISABLE_RE = re.compile(r"#\s*graphlint:\s*disable(?:=([A-Z0-9, ]+))?")


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for Attribute chains, 'int' for Names, ''
    otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _root_name(node: ast.AST) -> Optional[str]:
    """The variable an expression hangs off (``toks_host`` for
    ``toks_host[st.slot]``), through subscripts, attributes and calls."""
    while True:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return None


def _is_host_copy(node: ast.AST) -> bool:
    """``x.cpu()``, ``x.tolist()``, ``x.item()``, ``x.numpy()`` or
    ``x.to("cpu")``: a device-to-host copy."""
    if not isinstance(node, ast.Call) or not isinstance(node.func,
                                                        ast.Attribute):
        return False
    if node.func.attr in HOST_COPY_METHODS and not node.args:
        return True
    if node.func.attr == "to":
        for a in list(node.args) + [k.value for k in node.keywords
                                    if k.arg == "device"]:
            if isinstance(a, ast.Constant) and a.value == "cpu":
                return True
            if (isinstance(a, ast.Call) and _dotted(a.func) == "torch.device"
                    and a.args and isinstance(a.args[0], ast.Constant)
                    and a.args[0].value == "cpu"):
                return True
    return False


def _is_host_expr(node: ast.AST, host_names: Set[str]) -> bool:
    """True when the expression is a host value: numpy math (the
    reference's ``_is_host_numpy_expr``), the result of a host copy, a
    Python coercion, or a value hanging off a name bound from one."""
    if isinstance(node, ast.Call):
        if _is_host_copy(node):
            return True
        if isinstance(node.func, ast.Name) and node.func.id in (
                "int", "float", "bool", "len", "str"):
            return True
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and \
                _dotted(sub.func).split(".", 1)[0] in NUMPY_ALIASES:
            return True
    root = _root_name(node)
    return root is not None and root in host_names


def _is_tensor_expr(node: ast.AST, tensor_names: Set[str]) -> bool:
    """True when the expression computes on a tensor: a ``torch`` call, a
    tensor method, or a name bound from a tensor expression. Tensor
    metadata and host-returning torch functions are host data."""
    if isinstance(node, ast.Attribute) and node.attr in META_ATTRS:
        return False
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in META_METHODS:
            return False
        d = _dotted(f)
        if d in TORCH_HOST_FNS:
            return False
        if d.startswith("torch."):
            return True
        if isinstance(f, ast.Attribute) and f.attr in TENSOR_METHODS:
            return True
    if isinstance(node, ast.Name):
        return node.id in tensor_names
    return any(_is_tensor_expr(c, tensor_names)
               for c in ast.iter_child_nodes(node))


def _target_names(t: ast.AST) -> List[str]:
    return [n.id for n in ast.walk(t) if isinstance(n, ast.Name)]


def _bindings(fn: ast.AST) -> List[Tuple[List[str], ast.AST]]:
    """(names, value) for every simple assignment in the function."""
    out = []
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Assign):
            names = [n for t in sub.targets for n in _target_names(t)]
            out.append((names, sub.value))
        elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)) \
                and sub.value is not None:
            out.append((_target_names(sub.target), sub.value))
    return out


def _classify_names(fn: ast.AST) -> Tuple[Set[str], Set[str]]:
    """(tensor names, host names) of one function: a name is a host name
    when every binding of it is a host value, a tensor name when a binding
    computes on a tensor (iterated to a fixpoint over the bindings)."""
    binds = _bindings(fn)
    host_votes: Dict[str, bool] = {}
    for names, value in binds:
        is_host = _is_host_expr(value, set())
        for n in names:
            host_votes[n] = host_votes.get(n, True) and is_host
    host = {n for n, h in host_votes.items() if h}
    tensor: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for names, value in binds:
            if _is_host_expr(value, host) or not _is_tensor_expr(value,
                                                                  tensor):
                continue
            for n in names:
                if n not in tensor and n not in host:
                    tensor.add(n)
                    changed = True
    return tensor, host


def _sync_call(node: ast.Call, tensor: Set[str],
               host: Set[str]) -> Optional[str]:
    """The EG005 message for one call inside a decode loop, or None."""
    f = node.func
    if _dotted(f) == "torch.cuda.synchronize":
        return ("`torch.cuda.synchronize()` inside a decode loop waits for "
                "the card once a token; synchronize once after the loop")
    if _is_host_copy(node):
        what = ('.to("cpu")' if f.attr == "to" else f".{f.attr}()")
        if _is_host_expr(f.value, host):
            return None
        return (f"`{what}` inside a decode loop copies to the host once a "
                f"token (a device sync); keep the value on the card and "
                f"copy once after the loop")
    if isinstance(f, ast.Name) and f.id in ("float", "int", "bool") \
            and node.args:
        arg = node.args[0]
        if _is_host_expr(arg, host) or not _is_tensor_expr(arg, tensor):
            return None
        return (f"`{f.id}(...)` of a tensor inside a decode loop is a "
                f"per-token host sync; keep the value on the card")
    return None


# -- rule visitors ----------------------------------------------------------


def _functions(tree: ast.Module) -> Iterator[ast.AST]:
    for sub in ast.walk(tree):
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield sub


def _check_decode_loops(tree: ast.Module, path: str, emit) -> None:
    """EG005: per-token host syncs inside decode/generate loops (the
    reference's selection: every function under ``serve/``, and any whose
    name says generate or decode)."""
    in_serve = f"{os.sep}serve{os.sep}" in path
    for fn in _functions(tree):
        name_l = fn.name.lower()
        if not (in_serve or "generate" in name_l or "decode" in name_l):
            continue
        tensor, host = _classify_names(fn)
        for loop in ast.walk(fn):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in ast.walk(loop):
                if isinstance(node, ast.Call):
                    msg = _sync_call(node, tensor, host)
                    if msg is not None:
                        emit("EG005", node.lineno, msg)


def _literal_name_pattern(node: ast.AST) -> Optional[str]:
    """The statically-known name of a metric/span call's first argument:
    a string constant verbatim, an f-string with its holes as ``*``, or
    None (dynamic — EG007 stands down)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts: List[str] = []
        for piece in node.values:
            if isinstance(piece, ast.Constant) and isinstance(piece.value,
                                                              str):
                parts.append(piece.value)
            else:
                parts.append("*")
        return "".join(parts)
    return None


def _check_registered_names(tree: ast.Module, emit) -> None:
    """EG007 over every metric/span call site with a literal name."""
    from ..obs import names as obs_names

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        is_metric = (
            (isinstance(f, ast.Attribute)
             and f.attr in METRIC_FACTORY_METHODS)
            or (isinstance(f, ast.Name) and f.id in METRIC_CLASSES))
        is_span = ((isinstance(f, ast.Name) and f.id in SPAN_CALLEES)
                   or (isinstance(f, ast.Attribute)
                       and f.attr in SPAN_CALLEES))
        if not (is_metric or is_span):
            continue
        pattern = _literal_name_pattern(node.args[0])
        if pattern is None:
            continue  # dynamic name: not statically checkable
        if is_metric and not obs_names.metric_registered(pattern):
            emit("EG007", node.lineno,
                 f"metric name {pattern!r} is not in the registered "
                 f"vocabulary (obs/names.py); register it there or fix "
                 f"the typo — an unregistered series is never scraped")
        elif is_span and not obs_names.span_registered(pattern):
            emit("EG007", node.lineno,
                 f"span name {pattern!r} is not in the registered "
                 f"vocabulary (obs/names.py); register it there or fix "
                 f"the typo")


# -- driver -----------------------------------------------------------------


def _suppressed_lines(source: str) -> Dict[int, Optional[Set[str]]]:
    """line -> set of suppressed rule ids (None = all rules)."""
    out: Dict[int, Optional[Set[str]]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _DISABLE_RE.search(line)
        if m:
            rules = m.group(1)
            out[i] = ({r.strip() for r in rules.split(",") if r.strip()}
                      if rules else None)
    return out


def lint_source(source: str, path: str) -> List[Finding]:
    """All AST findings for one module's source text."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(layer="ast", rule="EG000", where=path,
                        line=e.lineno or 0,
                        message=f"syntax error: {e.msg}")]

    suppressed = _suppressed_lines(source)
    raw: List[Tuple[str, int, str]] = []

    def emit(rule: str, line: int, message: str) -> None:
        sup = suppressed.get(line)
        if line in suppressed and (sup is None or rule in sup):
            return
        raw.append((rule, line, message))

    _check_decode_loops(tree, path, emit)
    _check_registered_names(tree, emit)

    seen: Set[Tuple[str, int, str]] = set()
    findings = []
    for rule, line, message in raw:
        key = (rule, line, message)
        if key in seen:
            continue
        seen.add(key)
        findings.append(Finding(layer="ast", rule=rule, where=path,
                                line=line, message=message))
    return findings


def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        return lint_source(f.read(), path)


def iter_package_files(root: str) -> Iterator[str]:
    """Every .py under ``root``, skipping caches and the lint pkg itself
    (its fixture-shaped docstrings and rule tables would self-trip)."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git", "csrc"))
        if os.path.basename(dirpath) == "lint":
            dirnames[:] = []
            continue
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def lint_paths(paths) -> List[Finding]:
    out: List[Finding] = []
    for p in paths:
        out.extend(lint_file(p))
    return out


def collect_suppressions(paths) -> List[Tuple[str, int, Optional[Set[str]]]]:
    """Every ``# graphlint: disable=`` marker across ``paths``.

    Returns ``(path, line, rules)`` triples sorted by location; ``rules``
    is None for a bare ``disable`` (all rules) or the set of rule ids a
    comma-separated marker names. Feeds the CLI's ``--show-suppressed``
    audit so silenced lines stay reviewable instead of invisible.
    """
    out: List[Tuple[str, int, Optional[Set[str]]]] = []
    for p in paths:
        try:
            with open(p, "r", encoding="utf-8") as f:
                source = f.read()
        except OSError:
            continue
        for line, rules in sorted(_suppressed_lines(source).items()):
            out.append((p, line, rules))
    return sorted(out, key=lambda t: (t[0], t[1]))
