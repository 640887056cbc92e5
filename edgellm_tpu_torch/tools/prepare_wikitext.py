"""Build the WikiText-2 evaluation corpus exactly the way the reference does
(PyTorch port's copy of ``edgellm_tpu/tools/prepare_wikitext.py``: the same
CLI, the same output bytes).

The reference constructs its corpus as ``"\\n\\n".join(test["text"])`` over the
``wikitext-2-raw-v1`` test split and tokenizes the joined string in one call
(the reference's ``Experiments/Qwen2-0.5B/main.py:122-124``,
``Experiments/Pythia-70M/last_row_exp.py:49-55``) — 299,078 Qwen2 tokens
(``Notebooks/qwen2-0.5B_experiment.ipynb`` cell 5). The joining/tokenization
details define the PPL metric, so this tool pins them:

    python -m edgellm_tpu_torch.tools.prepare_wikitext \\
        --input <source> --tokenizer <local HF tokenizer dir> --output corpus.npy

``--input`` accepts, in order of fidelity:
- an HF datasets directory saved with ``save_to_disk`` (test split or a
  DatasetDict containing one) — the reference's own data path, fully offline;
- a ``.jsonl`` file with one ``{"text": ...}`` object per line (the raw rows);
- a ``.txt`` file assumed to be the ALREADY-JOINED corpus (written verbatim).

The output ``.npy`` (int32 token ids) feeds ``edgellm_tpu_torch.run --corpus``. A
``<output>.meta.json`` records the tokenizer path, document count, and token
count so a sweep's corpus provenance is auditable. ``datasets`` and
``transformers`` are imported inside the functions that need them.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

JOINER = "\n\n"  # Qwen2-0.5B/main.py:124


def load_texts(path: str):
    """-> (list of document strings, source_kind)."""
    if path.endswith(".jsonl"):
        with open(path) as f:
            return [json.loads(line)["text"] for line in f if line.strip()], "jsonl"
    if path.endswith(".txt"):
        with open(path) as f:
            return [f.read()], "joined-txt"
    # HF datasets directory (offline, save_to_disk layout)
    from datasets import load_from_disk

    ds = load_from_disk(path)
    if hasattr(ds, "keys") and "test" in ds:
        ds = ds["test"]
    return list(ds["text"]), "datasets-dir"


def build_corpus(texts, tokenizer_path: str, already_joined: bool = False):
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(tokenizer_path)
    joined = texts[0] if already_joined else JOINER.join(texts)
    ids = tok(joined, return_tensors="np").input_ids.reshape(-1)
    return np.asarray(ids, np.int32), joined


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True,
                    help="datasets dir (save_to_disk), .jsonl rows, or joined .txt")
    ap.add_argument("--tokenizer", required=True, help="local HF tokenizer path")
    ap.add_argument("--output", default="corpus.npy")
    args = ap.parse_args(argv)

    texts, kind = load_texts(args.input)
    ids, joined = build_corpus(texts, args.tokenizer, already_joined=(kind == "joined-txt"))
    np.save(args.output, ids)
    meta = {
        "tokenizer": args.tokenizer,
        "source": args.input,
        "source_kind": kind,
        "n_documents": len(texts),
        "n_chars_joined": len(joined),
        "n_tokens": int(ids.size),
        "joiner": JOINER,
    }
    with open(args.output + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    sys.exit(main())
