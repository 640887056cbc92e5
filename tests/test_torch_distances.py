"""The port's layer-distance analysis (``edgellm_tpu_torch.analysis``)
against the JAX package's on the CPU, and the ``distances`` experiment's
heatmap with and without matplotlib.

Weights come from the JAX package's ``init_params`` (``params_from_jax_numpy``),
samples are made with numpy from a seed at ragged lengths. Tolerance: each
distribution and the pairwise matrix within 1e-6 absolute (the same fp32
stats forward, other summation order; the divergences are float64 numpy in
both), NaN at the same places.
"""
import json

import numpy as np
import pytest
import torch

import jax

from edgellm_tpu import analysis as jan
from edgellm_tpu.models import init_params as j_init
from edgellm_tpu.models.configs import tiny_config as jtiny
from edgellm_tpu_torch import analysis as tan
from edgellm_tpu_torch import run as trun
from edgellm_tpu_torch.models.configs import tiny_config as ttiny
from edgellm_tpu_torch.models.convert import params_from_jax_numpy

TOL = 1e-6
#: (family, tiny_config keyword arguments)
MODELS = {
    "qwen2": ("qwen2", dict(num_layers=4, hidden_size=128, num_heads=2, num_kv_heads=1)),
    "neox": ("gpt_neox", dict(num_layers=4, hidden_size=32, num_heads=4, vocab_size=128)),
}
LENGTHS = (2, 7, 20, 33, 20, 64, 47, 12)


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    family, kw = MODELS[request.param]
    jcfg, tcfg = jtiny(family, **kw), ttiny(family, **kw)
    jp = j_init(jcfg, jax.random.key(3))
    tp = params_from_jax_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    samples = [rng.integers(0, jcfg.vocab_size, n) for n in LENGTHS]
    return jcfg, jp, tcfg, tp, samples


def _pairs():
    rng = np.random.default_rng(0)
    p, q = rng.random(16), rng.random(16)
    zp = p.copy()
    zp[::3] = 0.0
    return [(p / p.sum(), q / q.sum()), (zp / zp.sum(), q / q.sum()),
            (np.array([0.5, 0.5, 0.0]), np.array([0.25, 0.5, 0.25])),
            (np.array([1.0, 0.0]), np.array([1.0, 0.0])),
            (np.float32([0.1, 0.2, 0.7]), np.float32([0.3, 0.3, 0.4]))]


@pytest.mark.parametrize("i", range(len(_pairs())))
def test_kl_and_js_equal_the_references(i):
    p, q = _pairs()[i]
    assert tan.kl_divergence(p, q) == jan.kl_divergence(p, q)
    assert tan.kl_divergence(q, p) == jan.kl_divergence(q, p)
    assert tan.jensen_shannon_divergence(p, q) == jan.jensen_shannon_divergence(p, q)


@pytest.mark.parametrize("lengths,buckets", [
    (list(range(17, 117)), 4), ([8, 8, 16], 4), ([5, 300, 12, 12, 64, 1024, 2], 3),
    ([3], 1), (list(range(2, 60, 3)), 7)])
def test_bucket_lengths_equal_the_references(lengths, buckets):
    assert tan.bucket_lengths(lengths, buckets) == jan.bucket_lengths(lengths, buckets)


@pytest.mark.parametrize("max_compiles", [None, 3])
def test_layer_distributions_and_matrix_match_reference(model, max_compiles):
    jcfg, jp, tcfg, tp, samples = model
    want = jan.layer_importance_distributions(jcfg, jp, samples, max_compiles=max_compiles)
    got = tan.layer_importance_distributions(tcfg, tp, samples, max_compiles=max_compiles,
                                             device="cpu")
    assert len(got) == len(want) == jcfg.num_layers
    for g_layer, w_layer in zip(got, want):
        assert [g.shape for g in g_layer] == [np.asarray(w).shape for w in w_layer]
        for g, w in zip(g_layer, w_layer):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=0)
    if max_compiles is not None:  # clipped to at most max_compiles lengths
        assert len({g.shape for g in got[0]}) <= max_compiles
    matrix = tan.pairwise_layer_distances(got)
    want_matrix = jan.pairwise_layer_distances(want)
    np.testing.assert_array_equal(np.isnan(matrix), np.isnan(want_matrix))
    np.testing.assert_allclose(matrix, want_matrix, atol=TOL, rtol=0)
    upper = np.triu(np.ones_like(matrix, dtype=bool), 1)
    assert np.isfinite(matrix[upper]).all() and np.isnan(matrix[~upper]).all()


def test_pairwise_distances_refuse_an_empty_corpus():
    with pytest.raises(ValueError, match="no usable samples"):
        tan.pairwise_layer_distances([[], []])


@pytest.mark.parametrize("hide_matplotlib", [False, True])
def test_distances_heatmap_with_and_without_matplotlib(hide_matplotlib, tmp_path, capsys,
                                                       monkeypatch):
    """With matplotlib the CLI writes the PNG and names it; without it, it
    says so on stderr, prints ``"heatmap": null``, writes no PNG, and still
    writes the matrix and exits 0."""
    if hide_matplotlib:
        monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    rc = trun.main(["--params", json.dumps({"experiment": "distances", "max_length": 24}),
                    "--model", "tiny-qwen2", "--device", "cpu", "--output-dir", str(tmp_path),
                    "--synthetic-corpus-len", "100"])
    assert rc == 0
    captured = capsys.readouterr()
    summary = json.loads(captured.out.strip().splitlines()[-1])
    png = tmp_path / "layer_distances.png"
    assert summary["n_samples"] == 5 and summary["layers"] == 6  # 4 x 24 + a 4-token tail
    assert json.loads((tmp_path / "layer_distances.json").read_text())["n_samples"] == 5
    if hide_matplotlib:
        assert summary["heatmap"] is None and not png.exists()
        assert "no heatmap written" in captured.err
    else:
        assert summary["heatmap"] == str(png)
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
