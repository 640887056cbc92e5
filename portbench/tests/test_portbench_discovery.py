"""The harness finds every configuration, traffic mix, kind and per-layer
metric by the names in BENCHMARK.json, and a new one of each is added by
files alone."""
from __future__ import annotations

import json
import shutil
import textwrap

from portbench import harness


def test_every_name_has_its_file(bench):
    for cfg in bench["configs"]:
        loaded = harness.load_json("configs", cfg["name"])
        assert loaded["name"] == cfg["name"] and loaded["source"] == cfg["source"]
        assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    for cell in bench["workloads"]:
        mix = harness.load_json("traffic", cell["traffic"])
        kind = harness.load_kind(mix["kind"])
        for fn in ("setup", "window", "release", "check", "readings"):
            assert callable(getattr(kind, fn)), (cell["name"], fn)
        assert cell["chips"] == 1
    for m in bench["per_layer"]:
        reader = harness.load_metric(m["name"])
        assert (reader.SOURCE, reader.LAYER, reader.MOVES) == (m["source"], m["layer"], m["moves"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    for cell in bench["workloads"]:
        e2e, per_layer = harness.cell_metrics(bench, cell["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per_layer, cell["name"]
        for m in per_layer:
            assert m["moves"] in names, (cell["name"], m["name"])


def test_a_cell_config_mix_and_metric_added_by_files_alone(tmp_path, bench):
    root = tmp_path / "portbench"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = harness.load_json("configs", "qwen2-0.5b")
    cfg["name"] = "qwen2-0.5b-copy"
    (root / "configs" / "qwen2-0.5b-copy.json").write_text(json.dumps(cfg))
    mix = harness.load_json("traffic", "table-fp32")
    mix["window_batch"] = 4
    (root / "traffic" / "table-wb4.json").write_text(json.dumps(mix))
    (root / "metrics" / "chunks.sweep.py").write_text(textwrap.dedent('''
        SOURCE = "program_counter"
        LAYER = "device"
        MOVES = "scored_tokens_per_s"


        def read(t, ctx):
            return t.counters.get("chunks")
    '''))
    bench = dict(bench)
    bench["configs"] = bench["configs"] + [dict(bench["configs"][0], name="qwen2-0.5b-copy")]
    bench["workloads"] = bench["workloads"] + [
        {"name": "table-wb4.qwen2-0.5b-copy", "config": "qwen2-0.5b-copy",
         "traffic": "table-wb4", "chips": 1, "why": "a test cell"}]
    bench["per_layer"] = bench["per_layer"] + [
        {"name": "chunks.sweep", "unit": "chunks", "better": "higher",
         "source": "program_counter", "layer": "device", "moves": "scored_tokens_per_s",
         "workloads": ["table-wb4.qwen2-0.5b-copy"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = harness.load_benchmark(tmp_path)
    cell = harness.find_cell(loaded, "table-wb4.qwen2-0.5b-copy")
    assert harness.load_json("configs", cell["config"], root)["name"] == "qwen2-0.5b-copy"
    mix = harness.load_json("traffic", cell["traffic"], root)
    assert mix["window_batch"] == 4
    assert callable(harness.load_kind(mix["kind"], root).window)
    e2e, per_layer = harness.cell_metrics(loaded, cell["name"])
    assert [m["name"] for m in per_layer] == ["chunks.sweep"]
    t = harness.Trace()
    t.counters["chunks"] = 7
    assert harness.load_metric("chunks.sweep", root).read(t, None) == 7
