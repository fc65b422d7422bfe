"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix and metric resolved to its files by name."""
import json
import re
import shutil

import pytest

from portbench import spec

BENCH = spec.load_json(spec.REPO / "BENCHMARK.json")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert all(_line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.fullmatch(entry["name"])
    assert _line(entry["source"]) and entry["source"].startswith("https://")
    assert _line(entry["why"])
    assert entry["file"].startswith("portbench/")
    assert (spec.REPO / entry["file"]).is_file()
    assert len(entry["reduced"]) <= 16
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_entry(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.fullmatch(entry[key])
    assert entry["chips"] in (1, 4)
    assert _line(entry["why"])


def test_four_chip_cells_are_few():
    """At most one cell in four takes 4 chips (rounded down), and one
    always may."""
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(m):
    e2e = m in BENCH["end_to_end"]
    keys = ({"name", "unit", "better", "bound", "source"} if e2e else
            {"name", "unit", "better", "source", "layer", "moves"})
    assert set(m) - {"workloads"} == keys
    assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    assert (spec.REPO / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    if e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["workloads"]
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        # every cell that reports it reports the metric it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_setup_s_in_every_cell():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] == 0.25


@pytest.mark.parametrize("name", spec.every_cell())
def test_cell_resolves_to_its_files(name):
    cell = spec.resolve(name)
    for path in (cell.builder, cell.reference, cell.counts):
        assert path.is_file(), path
    for m in cell.end_to_end + cell.per_layer:
        assert cell.reader(m["name"]).is_file()
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert cell.limits and all(
        v["lower"] < v["limit"] < v["upper"] for v in cell.limits.values())
    for key in ("ring", "inflight", "profile_calls"):
        assert key in cell.traffic
    # a call's batch: the traffic's rows, or the configuration's images
    assert "rows" in cell.traffic or "images" in cell.sizes


def test_new_traffic_is_found_without_editing(tmp_path):
    """A cell added to a copy by new files and one new BENCHMARK.json
    entry resolves; no file of the harness changes."""
    shutil.copytree(spec.REPO / "portbench", tmp_path / "portbench")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [{
        "name": "conv960.quote64", "config": "conv960", "traffic": "quote64",
        "chips": 1, "why": "64 rows a call, one strike ladder a quote"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "traffic" / "quote64.json").write_text(
        json.dumps({"call": "forward", "rows": 64, "ring": 4,
                    "inflight": 1, "profile_calls": 64}))
    shutil.copy(tmp_path / "portbench" / "limits" / "conv960.book.json",
                tmp_path / "portbench" / "limits" / "conv960.quote64.json")
    cell = spec.resolve("conv960.quote64", root=tmp_path)
    assert cell.traffic["rows"] == 64 and cell.config == "conv960"
    assert cell.builder == tmp_path / "portbench" / "configs" / "conv960.py"
    assert all(before[p] == p.read_bytes() for p in before)
