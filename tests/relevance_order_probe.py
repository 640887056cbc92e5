"""Why ``tests/test_relevance.py::test_window_batched_relevance_matches_unbatched``
passes in one run and fails in another (not a test:
``python tests/relevance_order_probe.py [FIRST LAST]``).

The test's ``qwen_setup`` fixture draws the model's weights from torch's
global RNG, which its module seeds once when it is imported; under
pytest-xdist the fixture runs after whatever the worker ran before. This
script seeds torch with 0, draws n numbers (n = FIRST..LAST, default
2..79), then builds the fixture and makes the test's comparison: one line
a state with the largest |relevance| and the worst margin against the
test's tolerance (atol 1e-5, rtol 1e-4; positive fails).
"""
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import conftest  # noqa: E402,F401  (the CPU platform, before JAX initializes)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from edgellm_tpu.importance.relevance import run_relevance_extraction  # noqa: E402


def main():
    first, last = (int(a) for a in sys.argv[1:3]) if len(sys.argv) > 2 else (2, 79)
    spec = importlib.util.spec_from_file_location("test_relevance",
                                                  os.path.join(HERE, "test_relevance.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fixture = mod.qwen_setup._fixture_function
    corpus = np.random.default_rng(11).integers(0, 256, 150)
    for n in range(first, last + 1):
        torch.manual_seed(0)
        torch.rand(n)
        cfg, params, _, _ = fixture()
        want = run_relevance_extraction(cfg, params, corpus, max_length=32, stride=16)
        got = run_relevance_extraction(cfg, params, corpus, max_length=32, stride=16,
                                       window_batch=4)
        margin = float((np.abs(got - want) - (1e-5 + 1e-4 * np.abs(want))).max())
        print(f"n={n} max|relevance| {np.abs(want).max():.6g} worst margin {margin:.3e} "
              f"{'FAIL' if margin > 0 else 'ok'}", flush=True)


if __name__ == "__main__":
    main()
