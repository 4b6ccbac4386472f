"""Every cell, configuration, traffic mix and per-layer metric of
BENCHMARK.json is found by name in its own file, a cell made of new files
alone is found without an edit, and the file keeps to the benchmark's
contract."""

import json
import re
import shutil

import pytest

from h100bench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert "<parthenon/mesh>" in cell.deck_text()
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    assert set(cell.params["limits"]) >= {"ic_err", "dt_err", "gas_err"}


@pytest.mark.parametrize("path", sorted((spec.HERE / "metrics").glob("*.py")),
                         ids=lambda p: p.stem)
def test_every_metric_file_has_a_reader(path):
    """Each reader loads and finds nothing to read in an empty run."""
    from types import SimpleNamespace

    read = spec.metric_reader(path.stem)
    empty = SimpleNamespace(trace=None, host_trace=None, window={"cycles": 0, "seconds": 0.0, "counters": {}},
                            phases=None, calls={}, flops=None, dtype=None, phase_cycles=1)
    assert read(empty) is None


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["h100bench"]
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"] == f"h100bench/configs/{c['name']}.json"
        assert all(NAME.match(k) for k in c["reduced"])
    names = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        names.add(w["name"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    # every cell, and every cell a later change adds, reports the set-up time
    assert "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", names)) <= names
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"]) and NAME.match(m["name"])
        assert m["moves"] in e2e
        # each cell the metric lists reports the end-to-end metric it moves
        moved = e2e[m["moves"]].get("workloads", names)
        assert set(m["workloads"]) <= set(moved)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_cell_of_new_files_is_found(tmp_path):
    """A later change adds a cell by adding files and an entry alone."""
    here = tmp_path / "h100bench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "reference",
                                                                     "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "disk_sph_small", "source": "the test's",
                             "file": "h100bench/configs/disk_sph_small.json", "reduced": [],
                             "why": "a new configuration"})
    bench["workloads"].append({"name": "disk_sph_small.bursty", "config": "disk_sph_small",
                               "traffic": "bursty", "chips": 1, "why": "a new cell"})
    bench["end_to_end"].append({"name": "zone_cycles_per_s.bursty", "unit": "zone-cycles/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["disk_sph_small.bursty"]})
    bench["per_layer"].append({"name": "new_counter", "unit": "x", "better": "lower",
                               "source": "program_counter", "layer": "host loop",
                               "moves": "setup_s", "workloads": ["disk_sph_small.bursty"]})
    # a family's name on a quantity that has its reader already
    bench["per_layer"].append({"name": "launches_per_cycle.bursty", "unit": "kernels",
                               "better": "lower", "source": "device_trace",
                               "layer": "host loop", "moves": "zone_cycles_per_s.bursty",
                               "workloads": ["disk_sph_small.bursty"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    config = json.loads((spec.HERE / "configs" / "disk_sph.json").read_text())
    config["name"] = "disk_sph_small"
    (here / "configs" / "disk_sph_small.json").write_text(json.dumps(config))
    (here / "traffic" / "bursty.json").write_text(json.dumps({"overrides": {},
                                                              "perturb_amp": 0.01}))
    (here / "cells" / "disk_sph_small.bursty.json").write_text(
        (spec.HERE / "cells" / "disk_sph.uniform.json").read_text())
    (here / "metrics" / "new_counter.py").write_text("def read(run):\n    return 7.0\n")
    cell = spec.load_cell("disk_sph_small.bursty", root=tmp_path, here=here)
    assert cell.traffic["perturb_amp"] == 0.01
    assert [m["name"] for m in cell.per_layer] == ["new_counter", "launches_per_cycle.bursty"]
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "zone_cycles_per_s.bursty"]
    assert spec.quantity("zone_cycles_per_s.bursty") == "zone_cycles_per_s"
    assert spec.metric_reader("new_counter", here=here)(None) == 7.0
    from types import SimpleNamespace
    traced = SimpleNamespace(trace=SimpleNamespace(kernels=90, cycles=10))
    assert spec.metric_reader("launches_per_cycle.bursty", here=here)(traced) == 9.0


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no_such.cell")
