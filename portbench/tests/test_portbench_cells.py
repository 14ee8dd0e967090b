"""``BENCHMARK.json`` against the benchmark's contract, alone and with the
held rolling cells merged in, a whole run of each cell's driver on the
CPU, and a cell added by files and one entry."""

import json
import os
import re

import pytest

import tinyroot
from conftest import ROOT
from portbench.harness import run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench(held=False):
    if held:
        return tinyroot.merged_bench()
    with open(f"{ROOT}/BENCHMARK.json") as f:
        return json.load(f)


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


@pytest.mark.parametrize("held", [False, True])
def test_benchmark_json_keeps_the_contract(held):
    b = bench(held)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert all(one_line(w) for w in b["command"])
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and c["file"].startswith("portbench/")
        assert os.path.isfile(f"{ROOT}/{c['file']}")
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and one_line(w["why"])
        assert os.path.isfile(f"{ROOT}/portbench/traffic/{w['traffic']}.json")
        cells.add(w["name"])
    assert len(cells) == len(b["workloads"])
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(metrics) == len(set(metrics))
    e2e = {}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock",
                                                         "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = set(m.get("workloads", cells))
    assert e2e["setup_s"] == cells
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and one_line(m["layer"])
        assert set(m["workloads"]) <= e2e[m["moves"]]
        assert os.path.isfile(f"{ROOT}/portbench/metrics/{m['name']}.py")
        if m["name"].endswith("_roofline") or ".roofline" in m["name"] \
                or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        assert len([n for n, ws in e2e.items() if cell in ws]) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", ["gke15k.rolling", "k8s5k.rolling",
                                  "gke15k.preflight", "k8s5k.preflight"])
def test_each_cell_runs_and_proves_correct(cell, tmp_path, cpu_planner,
                                           sync_repaired):
    root = tinyroot.make(str(tmp_path))
    r = run_cell(root, cell, 2 ** 33 + 5, 3.0, False, require_cuda=False)
    assert r["correct"], r["notes"]
    assert r["attempted"] > 0 and r["failed"] == 0
    want = {m["name"] for m in bench(held=True)["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) == want
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell,spans,device", [
    ("k8s5k.rolling", {"list_ms.scan", "encode_ms.scan", "tick_ms.scan",
                       "report_ms.scan", "audit_ms.scan"},
     {"k1_roofline.scan", "device_idle.scan"}),
    ("k8s5k.preflight", {"list_ms.preflight", "encode_ms.preflight",
                         "tick_ms.preflight", "report_ms.preflight"},
     {"k1_roofline.preflight", "device_idle.preflight"}),
])
def test_a_traced_run_reports_the_per_layer_metrics(cell, spans, device,
                                                    tmp_path, cpu_planner,
                                                    sync_repaired):
    root = tinyroot.make(str(tmp_path))
    r = run_cell(root, cell, 77, 3.0, True, require_cuda=False)
    assert r["correct"], r["notes"]
    # off the card the device metrics have nothing to read
    assert spans <= set(r["metrics"])
    assert not device & set(r["metrics"])


def test_a_cell_is_added_by_files_and_one_entry(tmp_path, cpu_planner,
                                               sync_repaired):
    root = tinyroot.make(str(tmp_path))
    conf = f"{root}/portbench/configs/k8s5k.json"
    with open(conf) as f:
        cfg = json.load(f)
    cfg.update(name="lab300", nodes=300, name_prefix="lab")
    with open(f"{root}/portbench/configs/lab300.json", "w") as f:
        json.dump(cfg, f)
    with open(f"{root}/portbench/traffic/rolling.json") as f:
        mix = json.load(f)
    mix["rolling"]["fleet_share_per_min"] = 4.0
    with open(f"{root}/portbench/traffic/brisk.json", "w") as f:
        json.dump(mix, f)
    with open(f"{root}/BENCHMARK.json") as f:
        b = json.load(f)
    b["configs"].append({"name": "lab300", "source": "https://example.org",
                         "file": "portbench/configs/lab300.json",
                         "reduced": [], "why": "a test's cell"})
    b["workloads"].append({"name": "lab300.brisk", "config": "lab300",
                           "traffic": "brisk", "chips": 1,
                           "why": "a test's cell"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "k8s5k.rolling" in m.get("workloads", []):
            m["workloads"].append("lab300.brisk")
    with open(f"{root}/BENCHMARK.json", "w") as f:
        json.dump(b, f)
    r = run_cell(root, "lab300.brisk", 5, 3.0, False, require_cuda=False)
    assert r["correct"], r["notes"]
    assert {"scan_s", "plan_lag_p95_s", "setup_s"} == set(r["metrics"])
    assert r["attempted"] > 20
