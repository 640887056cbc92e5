"""The port's latticelint (``edgellm_tpu_torch.lint.lattice``) on the CPU:
the reference's oracle and fuzz tables, every refused pair refused by the
port's validator with the reference's message word for word, every feature
block valid alone, README parity with a seeded drift, the budget block's
validation, ``LL-budget`` through an injected ``peak_reader``, ``LL-donate``
on a rebuilt cache, and the capability matrix's features and refusal
reasons equal to the reference's on every shipped config."""
import json
import shutil
from pathlib import Path

import pytest
import torch

from edgellm_tpu.lint import lattice as ref_lattice
from edgellm_tpu.run import _validate_params_json as ref_validate
from edgellm_tpu_torch.lint import lattice
from edgellm_tpu_torch.run import _validate_params_json as port_validate

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"


def test_tables_are_the_reference_s():
    assert lattice.MATRIX_SCHEMA == ref_lattice.MATRIX_SCHEMA
    assert lattice.PAIR_ORACLE == ref_lattice.PAIR_ORACLE
    assert lattice.FUZZ_BLOCKS == ref_lattice.FUZZ_BLOCKS
    assert lattice.FUZZ_DEPS == ref_lattice.FUZZ_DEPS
    assert lattice.FUZZ_BASE == ref_lattice.FUZZ_BASE
    assert lattice.FEATURE_KEYS == ref_lattice.FEATURE_KEYS
    for rule in ("VALIDATE", "README", "LOWER", "BUDGET", "DONATE", "COMPAT"):
        assert getattr(lattice, f"RULE_{rule}") == getattr(ref_lattice, f"RULE_{rule}")


@pytest.mark.parametrize("pair", sorted(lattice.PAIR_ORACLE))
def test_refused_pair_word_for_word(pair):
    p = lattice.compose_combo(pair)
    got = lattice._validate(p, "cpu")
    assert got == lattice.PAIR_ORACLE[pair]
    assert got == ref_lattice._validate(p)


@pytest.mark.parametrize("block", sorted(lattice.FUZZ_BLOCKS))
def test_feature_block_validates_alone(block):
    p = lattice.compose_combo((block,))
    assert lattice._validate(p, "cpu") is None
    assert ref_lattice._validate(p) is None


def _copy_configs(tmp_path: Path, names=None) -> Path:
    d = tmp_path / "configs"
    d.mkdir()
    shutil.copy(CONFIGS / "README.md", d / "README.md")
    for path in CONFIGS.glob("*.json"):
        if names is None or path.stem in names:
            shutil.copy(path, d / path.name)
    return d


def test_readme_parity_and_seeded_drift(tmp_path):
    assert lattice.readme_parity_findings(CONFIGS) == []
    d = _copy_configs(tmp_path)
    assert lattice.readme_parity_findings(d) == []
    (d / "split99_unlisted.json").write_text('{"experiment": "split"}')
    got = lattice.readme_parity_findings(d)
    assert [f.rule for f in got] == ["LL-readme"]
    assert "split99_unlisted.json has no README table row" in got[0].message
    (d / "split99_unlisted.json").unlink()
    (d / "smoke.json").unlink()
    got = lattice.readme_parity_findings(d)
    assert [f.rule for f in got] == ["LL-readme"] and "smoke.json" in got[0].message
    assert [f.message for f in got] == [
        f.message for f in ref_lattice.readme_parity_findings(d)]


BAD_BUDGETS = [
    "1048576",
    {"aot_peak_bytes": 0},
    {"aot_peak_bytes": True},
    {"aot_peak_bytes": 1.5},
    {"note": "no ceiling"},
    {"aot_peak_bytes": 4096, "slack": 2},
    {"aot_peak_bytes": 4096, "note": 7},
]


@pytest.mark.parametrize("budget", BAD_BUDGETS, ids=range(len(BAD_BUDGETS)))
def test_budget_block_validation(budget):
    p = json.loads((CONFIGS / "split1_qwen_int8.json").read_text())
    p["budget"] = budget
    with pytest.raises(SystemExit) as port_err:
        port_validate(p, device="cpu")
    with pytest.raises(SystemExit) as ref_err:
        ref_validate(p)
    assert str(port_err.value) == str(ref_err.value)
    assert "budget" in str(port_err.value)


def test_budget_through_an_injected_peak_reader(tmp_path):
    """The footprint rule: the reader's increment plus the call's argument
    bytes, held against the config's own ``aot_peak_bytes``."""
    d = _copy_configs(tmp_path, names={"split1_qwen_int8"})
    (d / "README.md").write_text("| `split1_qwen_int8.json` | the lint's seed |\n")
    budget = json.loads((d / "split1_qwen_int8.json").read_text())["budget"]["aot_peak_bytes"]
    calls = []

    def reader(extra):
        def read(call):
            calls.append(call())
            return extra
        return read

    findings, checked, skipped, matrix = lattice.run_lattice_checks(
        configs_dir=d, pairwise=False, device="cpu", peak_reader=reader(0))
    assert findings == [] and skipped == [] and calls
    row = matrix["configs"]["split1_qwen_int8"]
    entry = row["entrypoints"]["split.forward"]
    assert entry["increment_bytes"] == 0 and entry["argument_bytes"] > 0
    assert row["peak_bytes"] == entry["total_bytes"] == entry["argument_bytes"] < budget
    assert row["budget_bytes"] == budget and checked == [
        "lattice.readme-parity", "lattice.config:split1_qwen_int8"]
    findings, _, _, matrix = lattice.run_lattice_checks(
        configs_dir=d, pairwise=False, device="cpu", peak_reader=reader(budget))
    assert [f.rule for f in findings] == ["LL-budget"]
    assert f"of {budget} bytes" in findings[0].message
    # a config without a budget block is a finding where one is required
    p = json.loads((d / "split1_qwen_int8.json").read_text())
    del p["budget"]
    (d / "split1_qwen_int8.json").write_text(json.dumps(p))
    findings, _, _, _ = lattice.run_lattice_checks(
        configs_dir=d, pairwise=False, device="cpu", peak_reader=reader(0))
    assert [f.rule for f in findings] == ["LL-budget"]
    assert 'missing "budget" block' in findings[0].message


def test_cpu_without_a_reader_skips_the_budget(tmp_path):
    d = _copy_configs(tmp_path, names={"smoke"})
    (d / "README.md").write_text("| `smoke.json` | the lint's seed |\n")
    findings, _, skipped, matrix = lattice.run_lattice_checks(
        configs_dir=d, pairwise=False, device="cpu")
    assert findings == []
    assert skipped == ["lattice budget: the footprint is measured on the card "
                       "(the cpu has no device allocator to read)"]
    assert matrix["configs"]["smoke"]["peak_bytes"] is None


def test_seeded_rebuilt_cache_is_ll_donate():
    k, v = torch.zeros(8), torch.zeros(8)
    assert lattice.donation_findings([k, v], [k, v], 2, "seed") == []
    got = lattice.donation_findings([k, v], [k.clone(), v], 2, "seed")
    assert [f.rule for f in got] == ["LL-donate"] and "keeps 1 " in got[0].message


@pytest.fixture(scope="module")
def sweep():
    return lattice.run_lattice_checks(device="cpu")


def test_shipped_lattice_is_clean(sweep):
    findings, checked, skipped, matrix = sweep
    assert findings == [], [f.format() for f in findings]
    configs = sorted(p.stem for p in CONFIGS.glob("*.json"))
    assert len(configs) == 28
    assert checked == (["lattice.readme-parity"]
                       + [f"lattice.config:{c}" for c in configs]
                       + ["lattice.pairwise-compat"])
    assert matrix["schema"] == ref_lattice.MATRIX_SCHEMA
    # the pair sweep refuses exactly the oracle's pairs
    refused = {tuple(label.split("+")) for label, row in matrix["pairs"].items()
               if row["refusal"] is not None}
    assert refused == set(lattice.PAIR_ORACLE)
    assert all(row["ok"] for row in matrix["pairs"].values() if row["refusal"] is None)


def test_matrix_features_and_refusals_are_the_reference_s(sweep):
    matrix = sweep[3]
    for path in sorted(CONFIGS.glob("*.json")):
        p = json.loads(path.read_text())
        row = matrix["configs"][path.stem]
        assert row["features"] == ref_lattice.config_features(p), path.stem
        assert row["refusal"] == ref_lattice._validate(p), path.stem
        assert row["valid"] is True
    for label, row in matrix["pairs"].items():
        assert row["refusal"] == ref_lattice._validate(
            ref_lattice.compose_combo(tuple(label.split("+")))), label
