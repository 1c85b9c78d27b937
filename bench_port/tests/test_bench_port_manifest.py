"""BENCHMARK.json against the benchmark's contract: keys, names, units,
files found by name, metrics reported where they move, the time budget."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
MAN = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion)")


def cells():
    return {c["name"]: c for c in MAN["workloads"]}


def reported(cell):
    e2e = {m["name"] for m in MAN["end_to_end"] if "workloads" not in m or cell in m["workloads"]}
    per = {m["name"] for m in MAN["per_layer"]
           if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in e2e)}
    return e2e, per


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert MAN["command"] == ["python3", "bench_port/run.py"]
    assert MAN["paths"] == ["bench_port"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_units_and_entry_keys():
    entries = MAN["configs"] + MAN["workloads"] + MAN["end_to_end"] + MAN["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names)), group
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
    for c in MAN["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["chips"] in (1, 4) and 1 <= len(c["why"]) <= 200
        assert NAME.match(c["traffic"])
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) and not WIDTHS.search(k) for k in c["reduced"])


def test_every_name_finds_its_files():
    for c in MAN["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        assert c["file"].startswith("bench_port/") and conf["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in MAN["workloads"]), c["name"]
    for name, c in cells().items():
        assert (REPO / "bench_port" / "workloads" / f"{name}.json").is_file()
        assert (REPO / "bench_port" / "limits" / f"{name}.json").is_file()
        assert c["config"] in {k["name"] for k in MAN["configs"]}
    for m in MAN["per_layer"]:
        assert (REPO / "bench_port" / "metrics" / f"{m['name']}.py").is_file(), m["name"]


@pytest.mark.parametrize("cell", sorted(cells()))
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e, per = reported(cell)
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for m in MAN["per_layer"]:
        if m["name"] in per:
            assert m["moves"] in e2e, (cell, m["name"])
    for m in MAN["end_to_end"]:
        assert set(m.get("workloads", ())) <= set(cells())


def test_layers_are_named_alike_and_rooflines_and_mfu_are_shares():
    for m in MAN["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
