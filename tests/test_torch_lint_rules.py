"""The port's AST and thread rules (``edgellm_tpu_torch.lint.ast_rules`` /
``threadlint``): EG005 in torch's vocabulary and EG007 against the port's
``obs/names.py`` catch their seeds and honour suppressions; the host rule
clears values already on the host; EG101 / EG102 / EG104 give the
reference's (rule, line) on the reference's own fixtures (read, never
imported); EG103 catches torch's syncing calls under a lock; and the
port's package is AST- and thread-clean, apart from the per-line
suppressions it carries."""
import os
from pathlib import Path

import pytest

from edgellm_tpu.lint import threadlint as ref_threadlint
from edgellm_tpu_torch.lint import ast_rules, threadlint

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "graphlint_fixtures"
PKG = REPO / "edgellm_tpu_torch"

#: every marker the port's sources carry (each listed in CHANGES.md)
SUPPRESSIONS = {("serve/disagg.py", "ok = bool(verify_payload(arrived))"),
                ("serve/disagg.py", "return {k: p[k].numpy() for k in p}"),
                ("serve/speculative.py", "if float(u) < float(probs[dj]):"),
                ("serve/speculative.py",
                 "emitted.append(int(prng.categorical(rkey, torch.log(resid))))"),
                ("serve/speculative.py", "feed.append(int(dlogits.argmax(dim=-1)[0]))")}


def _rules(src: str, path: str = "serve/t.py") -> list:
    return [(f.rule, f.line) for f in ast_rules.lint_source(src, path)]


DECODE_LOOP = """\
import numpy as np
import torch


def generate(model, steps, tok):
    toks = []
    for _ in range(steps):
        logits = model(tok)
        {line}
    return toks
"""

#: one per-token sync per seed, each on the loop body's line 9
SYNC_SEEDS = [
    "toks.append(logits.item())",
    "toks.append(logits.tolist())",
    "toks.append(logits.cpu())",
    "toks.append(logits.numpy())",
    'toks.append(logits.to("cpu"))',
    "tok = int(logits.argmax())",
    "tok = int(torch.argmax(logits))",
    "done = bool(logits.isnan().any())",
    "p = float(torch.softmax(logits, -1)[0])",
    "torch.cuda.synchronize()",
]


@pytest.mark.parametrize("line", SYNC_SEEDS)
def test_eg005_catches_torch_sync(line):
    assert _rules(DECODE_LOOP.format(line=line)) == [("EG005", 9)]
    # the marker on the line silences it; another rule's id does not
    marked = DECODE_LOOP.format(line=line + "  # graphlint: disable=EG005")
    assert _rules(marked) == []
    other = DECODE_LOOP.format(line=line + "  # graphlint: disable=EG007")
    assert _rules(other) == [("EG005", 9)]


HOST_VALUES = [
    "toks.append(int(toks_host[0]))",        # bound from a host copy before the loop
    "toks.append(float(arr[0]))",            # numpy
    "toks.append(int(np.argmax(arr)))",      # numpy math
    "toks.append(int(sum(counts)))",         # plain python
    "toks.append(float(load()))",            # a python callable
    "toks.append(int(logits.shape[0]))",     # tensor metadata
    "toks.append(int(logits.numel()))",
    'toks.append(int(target.split(":", 1)[1]))',
]

HOST_LOOP = """\
import numpy as np
import torch


def generate(model, steps, tok, load, counts, target):
    toks = []
    arr = np.zeros(4)
    toks_host = model(tok).cpu().numpy()
    for _ in range(steps):
        logits = model(tok)
        {line}
    return toks
"""


@pytest.mark.parametrize("line", HOST_VALUES)
def test_eg005_host_rule_clears_host_values(line):
    assert _rules(HOST_LOOP.format(line=line)) == []


def test_eg005_only_in_decode_loops():
    """Outside serve/ a function must say generate or decode, and the sync
    must sit in a loop (the reference's selection)."""
    src = DECODE_LOOP.format(line="toks.append(logits.item())")
    assert _rules(src.replace("def generate", "def helper"), "models/t.py") == []
    assert _rules(src, "models/t.py") == [("EG005", 9)]
    once = "def decode(x):\n    return int(x.argmax())\n"
    assert _rules(once, "serve/t.py") == []


def test_reference_eg005_fixture_same_lines():
    """The reference's seed (int(logits.argmax()), logits.item()) reads as
    torch and fires on the reference's lines."""
    path = str(FIXTURES / "bad_eg005.py")
    assert sorted({(f.rule, f.line) for f in ast_rules.lint_file(path)}) == \
        [("EG005", 9), ("EG005", 10)]


def test_host_rule_clears_batching_toks_host():
    """serve/batching.py reads its sampled tokens from ``toks_host``, one
    host copy a step made before the per-slot loop: no finding there."""
    path = PKG / "serve" / "batching.py"
    src = path.read_text()
    line = next(i for i, text in enumerate(src.splitlines(), 1)
                if "st.tokens.append(int(toks_host[st.slot]))" in text)
    assert "toks_host = " in src and "graphlint" not in src.splitlines()[line - 1]
    assert ast_rules.lint_file(str(path)) == []


EG007_SRC = """\
from edgellm_tpu_torch.obs.metrics import get_registry
from edgellm_tpu_torch.obs.tracing import span


def f(reg):
    reg.counter({metric!r}, "help").inc()
    with span({span!r}):
        pass
"""


def test_eg007_unregistered_names():
    good = EG007_SRC.format(metric="edgellm_disagg_wire_bytes_total",
                            span="lint.obs-identity-probe")
    assert _rules(good, "obs/t.py") == []
    bad_metric = EG007_SRC.format(metric="edgellm_typo_total",
                                  span="lint.obs-identity-probe")
    assert _rules(bad_metric, "obs/t.py") == [("EG007", 6)]
    bad_span = EG007_SRC.format(metric="edgellm_disagg_wire_bytes_total",
                                span="lint.no-such-span")
    assert _rules(bad_span, "obs/t.py") == [("EG007", 7)]
    silenced = bad_span.replace("with span('lint.no-such-span'):",
                                "with span('lint.no-such-span'):  # graphlint: disable")
    assert _rules(silenced, "obs/t.py") == []


@pytest.mark.parametrize("fixture", ["bad_eg101.py", "bad_eg102.py", "bad_eg104.py"])
def test_thread_rules_match_reference_on_its_fixtures(fixture):
    path = str(FIXTURES / fixture)
    got = sorted((f.rule, f.line) for f in threadlint.lint_file(path))
    want = sorted((f.rule, f.line) for f in ref_threadlint.lint_file(path))
    assert got == want and got, (got, want)
    assert all(f.layer == "thread" for f in threadlint.lint_file(path))


EG103_SRC = """\
import threading
import time

import torch


class Stager:
    def __init__(self):
        self._lock = threading.Lock()
        self.rows = []

    def stage(self, t, ev, path):
        with self._lock:
            torch.cuda.synchronize()
            ev.synchronize()
            self.rows.append(t.item())
            self.rows.append(t.cpu())
            self.rows.append(t.tolist())
            self.rows.append(t.to("cpu"))
            time.sleep(0.1)
            open(path).close()

    def fine(self, t):
        rows = t.cpu()
        with self._lock:
            self.rows.append(rows)
            self.rows.append(t.to("cuda"))
"""


def test_eg103_catches_torch_syncs_under_a_lock():
    got = [(f.rule, f.line) for f in threadlint.lint_source(EG103_SRC, "t.py")]
    assert got == [("EG103", n) for n in range(14, 22)]


def test_reference_eg103_fixture_keeps_host_io():
    """The reference's seed: sleep and open under the lock still fire;
    ``block_until_ready`` is JAX's wait and has no torch meaning."""
    got = [(f.rule, f.line) for f in threadlint.lint_file(str(FIXTURES / "bad_eg103.py"))]
    assert got == [("EG103", 13), ("EG103", 18)]


def test_port_package_is_thread_and_ast_clean():
    files = list(ast_rules.iter_package_files(str(PKG)))
    assert files and not any(f"{os.sep}lint{os.sep}" in f for f in files)
    assert threadlint.lint_files(files) == []
    assert ast_rules.lint_paths(files) == []
    marks = ast_rules.collect_suppressions(files)
    got = set()
    for path, line, rules in marks:
        assert rules == {"EG005"}, (path, line, rules)
        text = Path(path).read_text().splitlines()[line - 1]
        got.add((os.path.relpath(path, PKG), text.split("#")[0].strip()))
    assert got == SUPPRESSIONS
