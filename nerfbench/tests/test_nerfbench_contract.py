"""BENCHMARK.json against the rules the benchmark is held to: its keys,
names, units and lengths; every configuration, mix, limits file and
per-layer reader present under the benchmark's folder; the chip time of a
full check with 24 cells inside its limit."""
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "nerfbench/run.py"]
    assert B["paths"] == ["nerfbench"]
    assert 1 <= B["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_cells_and_files():
    confs = {c["name"]: c for c in B["configs"]}
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("nerfbench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and sorted(f["reduced"]) == sorted(
            c["reduced"])
    used = set()
    pairs = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in confs and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        assert (ROOT / "nerfbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "nerfbench/limits" / f"{w['name']}.json").is_file()
    assert used == set(confs)
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(B["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in B["workloads"]}
    names = set()
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (ROOT / "nerfbench/metrics" / f"{m['name']}.py").is_file()
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    # every cell reports setup_s, another end-to-end metric and a per-layer
    for c in cells:
        mine = [m for m in B["end_to_end"] if c in m.get("workloads", [c])]
        assert len(mine) >= 2
        assert any(c in m.get("workloads", [c]) for m in B["per_layer"])
