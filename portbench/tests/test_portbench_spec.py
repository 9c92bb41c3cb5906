"""BENCHMARK.json against the benchmark's contract, and the harness's
discovery of configurations, mixes, metrics and limits as files."""

import json
import math
import re
import shutil

from portbench import spec

BENCH = spec.load_benchmark()
WHY = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_command_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(WHY.match(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (spec.ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_one_line_texts():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(spec.NAME_RX.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT_RX.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert spec.NAME_RX.match(w["config"])
        assert spec.NAME_RX.match(w["traffic"])
        assert WHY.match(w["why"])
    for c in BENCH["configs"]:
        assert WHY.match(c["why"]) and WHY.match(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(spec.NAME_RX.match(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert WHY.match(m["layer"])


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_what_its_metrics_need():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in cells:
        mine = [m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")]
        assert "setup_s" in mine and len(mine) >= 2, cell
        assert spec.metrics_of(BENCH, cell, "per_layer"), cell
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells), (m, cell)


def test_every_named_file_is_there():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert spec.load_config(BENCH, c["name"])
    for w in BENCH["workloads"]:
        mix = spec.load_mix(w["traffic"])
        assert (spec.ROOT / "portbench" / "drivers" /
                f"{mix['driver']}.py").is_file()
        limits = spec.load_limits(w["name"])
        assert all(v >= 0 for v in limits.values())
        config = spec.load_config(BENCH, w["config"])
        for k in next(c for c in BENCH["configs"]
                      if c["name"] == w["config"])["reduced"]:
            assert k in config["paper"] and config[k] != config["paper"][k]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.load_metric(m["name"]).read)


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(0.25 * len(BENCH["workloads"])))


def test_a_config_mix_metric_and_cell_added_as_files_are_taken_up(
        tmp_path, tiny_run):
    from portbench import run
    from portbench.tests.conftest import TINY, TINY_LIMITS

    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(spec.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    config, mix = TINY["sasrec.train"]
    (root / "portbench/configs/seqrec-tiny.json").write_text(
        json.dumps(config))
    (root / "portbench/mixes/seqrec_train_tiny.json").write_text(
        json.dumps(mix))
    (root / "portbench/limits/seqrec.tiny.json").write_text(
        json.dumps(TINY_LIMITS))
    (root / "portbench/metrics/units_in_window.py").write_text(
        "def read(run):\n    return float(run.units)\n")
    bench["configs"].append({"name": "seqrec-tiny", "source": "x",
                             "file": "portbench/configs/seqrec-tiny.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "seqrec.tiny", "config": "seqrec-tiny",
                               "traffic": "seqrec_train_tiny", "chips": 1,
                               "why": "tiny"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_step_ms":
            m["workloads"].append("seqrec.tiny")
    bench["end_to_end"].append({"name": "units_in_window", "unit": "runs",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["seqrec.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = spec.load_benchmark(root)
    result, _ = run.execute(loaded, spec.cell(loaded, "seqrec.tiny"), 3, 0.2,
                            False, device="cpu", root=root)
    assert result["correct"]
    assert set(result["metrics"]) == {"setup_s", "train_step_ms",
                                      "units_in_window"}
    assert result["metrics"]["units_in_window"]["value"] >= 1


def test_the_tiny_limits_are_no_tighter_than_the_cells():
    from portbench.tests.conftest import TINY, TINY_LIMITS

    for cell in TINY:
        for k, v in spec.load_limits(cell).items():
            assert TINY_LIMITS[k] >= v, (cell, k)
