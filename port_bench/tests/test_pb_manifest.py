"""BENCHMARK.json against the benchmark's contract and its own files."""

import json
import re

import pytest

from port_bench import common

MAN = common.load_json(common.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len(json.dumps(MAN).encode()) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert MAN["paths"] == ["port_bench"]
    assert MAN["command"][1] == "port_bench/run.py"


def test_names_units_and_entry_keys():
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                             "workloads"}}
    for key, keys in allowed.items():
        names = [e["name"] for e in MAN[key]]
        assert len(names) == len(set(names))
        for e in MAN[key]:
            assert set(e) <= keys, (key, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in MAN["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist_and_load(cell):
    c = common.load_cell(cell)
    assert c.chips == 1
    driver = c.traffic["driver"]
    assert (common.BENCH_DIR / "drivers" / f"{driver}.py").exists()
    assert "limits" in c.settings
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert (common.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()


def test_per_layer_workloads_report_what_they_move():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in CELLS
            assert w in moved.get("workloads", CELLS), (m["name"], w)


def test_configs_used_and_their_files():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["file"].startswith("port_bench/")
        body = common.load_json(common.ROOT / c["file"])
        assert body["reduced"] == c["reduced"] == []
        assert body["source"] == c["source"]


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert layers == {"HTTP and micro-batching", "vocoder entry", "sampler kernel",
                      "whole served path", "train step", "device"}
