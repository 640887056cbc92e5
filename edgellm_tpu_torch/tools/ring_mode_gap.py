"""The accuracy cost of ``ring_selective_int4(mode="local")`` against the
exact ``mode="global"`` (PyTorch counterpart of
``edgellm_tpu/tools/ring_mode_gap.py``).

``mode="local"`` is the wire-optimal variant (per-shard payloads of the
dense codec's bytes per token); its selected token set is each shard's own
rather than the dense global argsort's, so its NLL is close to but not equal
with the global mode's (``codecs/ring_codecs.py``). This tool runs both
modes through the whole ``SplitRingRuntime`` at
``configs/split5b_qwen_ring_selective.json``'s shape (qwen2-0.5b, cut 11,
S = 2048, n_seq = 4) with synthetic bf16 weights and prints one JSON line a
(window, ratio) with the two NLLs and |dNLL|, then ``worst_dnll``. The
shards of a stage run in turn on one device.

    python -m edgellm_tpu_torch.tools.ring_mode_gap [--device cpu]
"""
from __future__ import annotations

import argparse
import json


def measure(model="qwen2-0.5b", seq: int = 2048, n_seq: int = 4, cut: int = 11,
            ratios=(0.25, 0.5), windows: int = 2, seed: int = 0, *, params=None,
            device="cuda") -> list:
    """Per (window, ratio): ``{"window", "ratio", "nll_global", "nll_local",
    "dnll"}``. ``model`` is a preset name or a ``ModelConfig``; ``params``
    defaults to synthetic bf16 weights from ``seed`` on ``device``; the
    windows are ``seq`` random token ids from ``numpy.random.default_rng(seed)``,
    and the hop's importance is the ring's own last-row importance at
    ``cut``."""
    import numpy as np
    import torch

    from ..codecs.ring_codecs import ring_selective_int4
    from ..models.configs import PRESETS
    from ..models.transformer import init_params, nll_from_logits
    from ..parallel.ring import SplitRingRuntime, importance_sp

    cfg = PRESETS[model] if isinstance(model, str) else model
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_params(cfg, gen, dtype=torch.bfloat16, device=device)
    # one runtime (and one placement) per (ratio, mode), out of the window loop
    runtimes = {(ratio, mode): SplitRingRuntime(
        cfg, (cut,), (ring_selective_int4(ratio, "bf16", n_seq=n_seq, mode=mode),), n_seq,
        device) for ratio in ratios for mode in ("global", "local")}
    placed = {key: rt.place_params(params) for key, rt in runtimes.items()}
    rng = np.random.default_rng(seed)
    out = []
    with torch.inference_mode():
        for w in range(windows):
            ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, seq)))
            imp = importance_sp(cfg, params, ids, n_seq, "last_row", device=device)[cut, 0]
            for ratio in ratios:
                nll = {}
                for mode in ("global", "local"):
                    logits = runtimes[(ratio, mode)].forward(placed[(ratio, mode)], ids,
                                                             hop_importance=[imp])
                    nll[mode] = float(nll_from_logits(logits, ids.to(logits.device)))
                rec = {"window": w, "ratio": ratio, "nll_global": nll["global"],
                       "nll_local": nll["local"], "dnll": abs(nll["local"] - nll["global"])}
                print(json.dumps(rec), flush=True)
                out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = measure(device=args.device)
    print(json.dumps({"worst_dnll": max(r["dnll"] for r in rows)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
