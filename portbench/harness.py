"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in
``portbench/configs/<config>.json``, its traffic mix in
``portbench/traffic/<mix>.json``, the loop the mix's window drives in
``portbench/drivers/<driver>.py``, and each per-layer metric's reader in
``portbench/metrics/<metric>.py``. A new cell is files and one entry.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer ones with ``--trace 1``), ``device``,
``breakdown`` (traced runs) and, last, ``checks``: each number the
judgement compared, with its limit. The same numbers close standard
error. With no CUDA card, too few of them, or any of jax, jaxlib, flax
or the JAX package loaded once the window has closed, the run prints no
result and exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

from portbench.common import Context, Outcome

#: top-level modules that may not be loaded in a run (the JAX reference
#: package, its entry shim and what it loads), compared whole: the
#: port's name begins with the reference's
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_cc_manager", "__graft_entry__")


class NoDevice(RuntimeError):
    pass


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, section: str, workload: str) -> List[dict]:
    """The metrics of ``section`` a cell reports."""
    return [m for m in bench[section]
            if "workloads" not in m or workload in m["workloads"]]


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, *, control: bool = False,
             require_cuda: bool = True, t_start: Optional[float] = None,
             fault: Optional[Callable[[dict], None]] = None) -> dict:
    """One run of ``workload``; the result line as a dict."""
    t_start = time.monotonic() if t_start is None else t_start
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    os.environ.update(cfg["env"])
    import torch

    import tpu_cc_manager_torch  # noqa: F401  (the system under test)

    cuda = torch.cuda.is_available()
    if require_cuda and (not cuda or torch.cuda.device_count() < cell["chips"]):
        raise NoDevice(
            f"the cell needs {cell['chips']} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if cuda else 0}")
    driver = load_file(os.path.join(root, "portbench", "drivers",
                                    mix["driver"] + ".py"),
                       f"portbench_driver_{mix['driver']}")
    run_dir = os.path.join(root, ".portbench_runs", workload)
    ctx = Context(cfg=cfg, mix=mix, seed=seed, seconds=seconds, trace=trace,
                  control=control, cuda=cuda, t_start=t_start,
                  run_dir=run_dir, fault=fault)
    out: Outcome = driver.run(ctx)
    metrics: Dict[str, dict] = {}
    if trace:
        for m in cell_metrics(bench, "per_layer", workload):
            reader = load_file(os.path.join(root, "portbench", "metrics",
                                            m["name"] + ".py"),
                               "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(out.trace) if out.trace is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, "end_to_end", workload):
            if m["name"] in out.e2e:
                metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell["chips"] if cuda else 0,
              "memory_peak_bytes": out.memory_peak_bytes}
    if cuda:
        device["power"] = power_limit()
    if trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.window_s
    correct = all(v <= lim for v, lim in out.checks.values())
    result = {"correct": bool(correct), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    if trace and out.breakdown is not None:
        result["breakdown"] = out.breakdown
    result["notes"] = out.notes
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.checks.items()}
    return result


def main(argv: Optional[List[str]] = None,
         t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the reference computed in the precision "
                         "below the configuration's in the program's place")
    args = ap.parse_args(argv)
    try:
        result = run_cell(os.getcwd(), args.workload, args.seed,
                          args.seconds, bool(args.trace),
                          control=bool(args.control), t_start=t_start)
    except NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for note in result["notes"]:
        print(f"portbench: {note}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
