"""A checkout-shaped directory for a test: ``BENCHMARK.json`` with the
held rolling cells merged in, and the benchmark's data files, with the
configurations cut to a size a test can hold and the mixes' lead and
drain shortened."""

from __future__ import annotations

import json
import os
import shutil

from conftest import ROOT

TINY_NODES = {"gke15k": 720, "k8s5k": 240}


def merged_bench() -> dict:
    """``BENCHMARK.json`` with ``portbench/held/rolling.json``'s entries
    added, as a later PR would add them."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    with open(os.path.join(ROOT, "portbench", "held", "rolling.json")) as f:
        held = json.load(f)
    for section in ("workloads", "end_to_end", "per_layer"):
        b[section] += held[section]
    return b


def make(dst: str, nodes=None, mix_edits=None) -> str:
    os.makedirs(os.path.join(dst, "portbench"), exist_ok=True)
    for d in ("configs", "traffic", "drivers", "metrics"):
        shutil.copytree(os.path.join(ROOT, "portbench", d),
                        os.path.join(dst, "portbench", d))
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(merged_bench(), f)
    for conf, n in (nodes or TINY_NODES).items():
        p = os.path.join(dst, "portbench", "configs", conf + ".json")
        with open(p) as f:
            cfg = json.load(f)
        cfg["nodes"] = n
        cfg["pool_nodes"] = max(1, n // 4)
        with open(p, "w") as f:
            json.dump(cfg, f)
    for mix in ("rolling", "preflight"):
        p = os.path.join(dst, "portbench", "traffic", mix + ".json")
        with open(p) as f:
            m = json.load(f)
        m["lead_s"] = 1
        m["warm_calls"] = 1
        if "drain_max_s" in m:
            m["drain_max_s"] = 5
        if "rolling" in m:
            # a fleet this small needs a faster pace for flips in a
            # short window
            m["rolling"]["fleet_share_per_min"] = 2.0
        m.update((mix_edits or {}).get(mix, {}))
        with open(p, "w") as f:
            json.dump(m, f)
    return dst
