#!/usr/bin/env python3
"""Drive the PyTorch port (the fleet planner, the node's flip, the node
agent, the rollout, the policy controller, the sharded control plane, the
scenario lab and the sysfs device backend) on one NVIDIA GPU and check
it, then run the port's analyzer on the card's machine.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device, ``nvcc`` and the repository's ``tpu_cc_manager_torch`` package; it
exits non-zero without them, and whenever any phase fails.

1. Build: the CUDA kernels compile from ``tpu_cc_manager_torch/csrc``;
   the launch floor (one empty kernel through the same ctypes route,
   timed like every kernel).
2. Kernels against their plain PyTorch versions, on the card, at the
   shapes the main path gives them: K1 ``fleet_tick`` at 131,072 and
   1,048,576 rows (the 100k bucket pads 24 % of its rows onto slot
   nb - 1), at phase 9's fleet scan of two nodes (64 rows, 8 pools), a
   padded fleet with empty slots, out-of-range indices, every
   row in one slot, every row in one pool, a 1M bucket padded at 24 %,
   131,071 rows and a block at a 4-byte storage offset (the row pass's
   scalar path); K1's partial form on the first (unpadded) and the last
   (padded) of 8 shards of 1,048,576 rows with hostile slice ids and K4
   ``mesh_combine`` over the 8 partials; K3 ``fleet_plan`` (its one-CTA
   kernel) at ``graft_entry.entry()``'s shape, at 257, 258 and 259 rows,
   with hostile codes and slice ids at 1,024 rows, and at the one-CTA
   kernel's row and slot limits and one past each (K1's route); K2
   ``delta_scatter`` on one block at 64 and 16,384 delta slots, with
   indices below 0 and past the end and padding. Every output must be
   equal; each is timed with CUDA events (median of 25 after warm-up),
   K1's and its partial form's launches one by one with
   ``torch.profiler`` (the ``k1_split`` line), and K2's and K3's device
   kernels per call counted with it.
3. Main path at 100,000 nodes: the CLI (``plan.main --from-file``) on a
   seeded NodeList, then ``analyze_pools`` over 8 pools with a
   ``PoolScanScratch``, twice; every report is checked against a numpy
   evaluation on the host.
4. Main path at 1,000,000 nodes: a ``TickSession`` adopts a synthetic
   encoding, takes 4 incremental ticks at 1 % deltas and one forced full
   (verifying) tick.
5. ``graft_entry.entry()``'s function on its example fleet.
6. K5 ``probe_add_one`` against its plain version on ``cuda:0``: the
   probe's own 1.0 and a seeded vector must come back bit-equal; the
   kernel is timed beside its plain version and the one PyTorch call
   ``x + 1.0``, and ``CudaBackend.probe_device(0)``'s round trip on the
   host clock.
7. The flip cycle on the card: ``python -m tpu_cc_manager_torch
   probe-devices`` in a subprocess, then ``ModeEngine`` over
   ``CudaBackend`` flips on → off → devtools, each verified through
   ``get_modes()`` and ``python -m tpu_cc_manager_torch get-cc-mode``,
   with ``runtime_gen`` advancing once and K5 launching in ``wait_ready``
   per flip; then phase 4's session ticks to the same outputs as before
   the resets. The mode store lives in a temporary directory, and
   ``/dev/nvidia*`` keeps its permission bits.
8. The mesh (``TPU_CC_PLANNER_MESH``): (a) K2 over the 8 shard blocks
   of one card in one launch at 16,384 delta slots with every shard's
   edge rows, indices no shard owns and padding, and K3 over the dry
   run's 8 shards in one launch and at its cross-check, each bit-equal
   to its plain version (K1's partial form and K4 are held in phase 2);
   (b) phase 4's 1M-row session at 1 % deltas on 8 shards on ``cuda:0``
   (rebuild, three incremental ticks, a forced full tick), every output
   array equal to the 1-shard session's, with the device time of the
   shards' partials, the peer copies and K4, from events that
   ``plan._mesh_tick`` records at its own stage boundaries, and the peak
   memory of both;
   (c) ``graft_entry.dryrun_multichip(8)``; (d) ``FleetController.
   scan_once`` over a ``FakeKube`` of phase 3's 100,000 nodes at 8 shards
   and at 1, equal reports, and ``python -m tpu_cc_manager_torch
   fleet-controller --once`` against a ``FakeApiServer`` of 1,000 nodes;
   (e) with two cards or more, (b) again at 2 shards per card over every
   card.
9. The node agent on the card, with its mode store in a temporary
   directory, on one HGX node of 8 GPU-consuming pods beside a second
   node of 8 that must not be touched: (a) ``CCManagerAgent`` over a
   ``FakeKube`` with ``drain_strategy="node"`` and ``CudaBackend`` on
   every card, driven on → off → devtools from another thread
   (``run(max_reconciles=3)``, 8 pods rescheduled before each flip);
   after each reconcile the state label and ``get_modes()`` agree, the
   node was cordoned and tainted during the flip and is neither after
   it, its 8 pods were evicted and the other node's are untouched,
   ``runtime_gen`` advanced once, K5 launched at least once per card,
   and the evidence names every card's PCI path and the mode; one
   ``agent_reconcile`` line each, with ``reconcile_s`` on the host clock
   (label write to reconcile counted; the first from the agent's start)
   and the tracer's spans. (b) Against
   a ``FakeApiServer`` through a kubeconfig, in subprocesses: ``python -m
   tpu_cc_manager_torch set-cc-mode -m on`` with ``DRAIN_STRATEGY=node``,
   ``doctor --publish``, and the long-lived agent, which follows a label
   change to ``off`` and exits 0 within ``SIGTERM_TIMEOUT_S`` of SIGTERM.
   (c) ``FleetController.scan_once`` over (a)'s ``FakeKube``, each of
   its K1 launches held bit-equal to K1's plain version on the same
   block: the node reads converged, with fresh evidence, the agent's
   passing doctor verdict and no problem. No platform identity or attestation provider
   is asked (``TPU_CC_IDENTITY=none``, ``TPU_CC_ATTESTATION=none``);
   ``/dev/nvidia*`` and the repository root stay as they were.
10. The controllers that bind the planner, on one shard, with phase 9's
   provider settings: (a) ``PolicyController.scan_once`` over a
   ``FakeKube`` of phase 3's 100,000 nodes in 8 TPUCCPolicy pools
   (targets on, off, devtools in turn), cold and again after 1 % of the
   nodes change state: each K1 launch bit-equal to K1's plain version and
   each K2 launch to K2's plain version on the block as it stood before
   it, every policy's counts equal to the host evaluation (the
   ``policy_scan`` line: host seconds, the kernels' device time and
   launches); (b) ``Rollout(kube, "on", dry_run=True).run()`` over the
   same nodes: its one K1 launch held to its plain version, one group per
   slice and solo node, the preflight equal to the host evaluation (the
   ``rollout_preflight`` line); (c) phase 9's node with its 8 pods beside
   the untouched node and ``CCManagerAgent`` over ``CudaBackend`` on every
   card, from ``devtools``: a ``Rollout`` to ``on`` with evidence
   verification selecting the node ends ok, then a TPUCCPolicy targeting
   ``devtools`` over it is reconciled by ``PolicyController`` until
   Converged; each flip checked as in phase 9, K5 once per card per flip
   (the ``rollout_flip`` and ``policy_flip`` lines: wall time, the group's
   time, the agent's spans); (d) ``python -m tpu_cc_manager_torch rollout
   -m on --dry-run`` and ``policy-controller --once`` in subprocesses
   against a ``FakeApiServer`` of 1,000 converged nodes under one policy.
11. The sharded control plane, on one planner shard, with phase 9's
   provider settings. (a) ``ShardManager`` (4 consistent-hash shards on
   2 hosts, a lease each at the reference's lease settings, a fleet and a
   policy controller per held lease) over a ``FakeKube`` of phase 3's
   100,000 nodes in 8 TPUCCPolicy pools, two per shard: once every shard
   has scanned, each shard's fleet report and policy statuses equal the
   host evaluation of its partition, the policies' counts equal phase
   10's, and the merged ``/fleet/metrics`` fetched from the manager is a
   valid exposition holding the fleet's counts; then 1 % of the nodes
   change and every shard's reports follow (the rows a stale-list
   reconcile left wrong are counted first); then host-0 dies and host-1
   takes its shards, whose new controllers scan again; no lease changes
   hands otherwise, and device memory is back to its level once the
   manager and its threads are gone (the ``shard_scan`` line). (b) A
   ``FleetObserver`` with ``deployments/slo.yaml``'s objectives over the
   manager's ``/fleet/metrics`` and each shard's exposition, before and
   after the churn: every scrape valid, the merge valid, no objective
   that can never fire (``slo_observe``). (c) ``FederationManager`` over
   two regions of 10,000 nodes in 4 pools on 2 shards each, phase 9's
   node and pods in region-a with ``CCManagerAgent`` over ``CudaBackend``:
   a posture to ``on`` with region-b's window 60 s away flips the
   agent's cards (K5 once per card) and region-a converges while region-b
   reads ``off``; region-a's evacuation collapses region-b's window and
   cordons region-a; once the posture holds, five converged checks read
   no node from either API server (``federation``). Every K1 and K2
   launch of a shard or region thread is recorded with its difference
   from its plain version and required 0 in the main thread.
12. The scenario lab, on one planner shard, with phase 9's provider
   settings: the bench's four lab runs (``bench.py``), each scenario as
   written in ``scenarios/``, replicas over the fake device backend and
   every controller planning on ``cuda:0``: (a) ``SimLab`` on
   ``scale-256`` (256 live replicas in 8 pools, the fleet and policy
   controllers, watch drops, agent crashes, a throttle squeeze, a 410
   and two list 429s): the artifact ok, all 256 nodes read
   ``cc.mode.state=on``, K1 and K2 launched; (b) ``scale-1024`` (1,024
   replicas, 16 pools, 4 controller shards, host 0 killed and restarted,
   host 1 killed): ok, with ``pool1024_convergence_s`` and
   ``shard_failover_convergence_s``, K1 from every shard's session; (c)
   ``upgrade-256`` (a rolling agent upgrade between two waves, no
   controller, so no kernel); (d) ``FederationLab`` on
   ``federation-2x512`` (two regions of 512 nodes, 2 shards each, a
   partition and an evacuation): ``region_evac_convergence_s``, K1 from
   both regions' shards. Each run's ``check_run`` finds no violation,
   each lab's every K1 and K2 launch (from whatever thread) is held to
   its plain version in the main thread once the lab has stopped, and
   device memory is back to its level once its threads have ended (one
   ``simlab`` line each: convergence, the watch pump's lag, throttle
   waits, host seconds, kernels, busy share, peak memory). Then (e)
   ``python -m tpu_cc_manager_torch simlab validate scenarios/*.json``,
   (f) ``simlab run scenarios/smoke-64.json --out`` and (g) ``simlab
   propgen --seeds 1,2 --families shards,policy`` in subprocesses, with
   no find and nothing written under ``scenarios/``.
13. The sysfs backend (``device/gpu.py``) on the card's host: (a) a
   read-only scan of ``/sys/bus/pci/devices`` (every NVIDIA function's
   bdf, class and device id; the GPUs' paths, names and capability; the
   NVSwitches), with the PCI address ``CudaBackend`` reads for ``cuda:0``
   held to one of the sysfs GPUs, whose ``/dev/nvidia<minor>`` exists,
   and, with ``CUDA_VISIBLE_DEVICES`` unset, the two backends' address
   sets held equal. A host whose sysfs holds no PCI tree (a sandbox)
   runs the rest over the one-function tree and driver file a card's
   host shows, built from the card's PCI address, ``nvidia-smi``'s
   device id and the minor of the devfs node the CUDA runtime holds, and
   against the real ``/dev``. (b) A read-only holder scan of the card's
   node. (c) ``ModeEngine`` over the sysfs backend flips on, off,
   devtools (no gate, no holder check, ``TPU_SYSFS_RESET_ATTR`` unset),
   each flip verified through ``get_modes()``, ``get-cc-mode`` and
   ``probe-devices --backend sysfs`` in subprocesses and
   ``verify_independent`` (through ``tpudevctl``, built from ``native/``
   when ``make`` and ``g++`` are there); then ``doctor --offline``. (d)
   No reset opened a file under sysfs for writing, ``/dev/nvidia*`` keep
   their mode bits, and K5 through ``CudaBackend.probe_device(0)`` (one
   launch) still answers, held bit-equal to its plain version.
14. The port's analyzer (``python -m tpu_cc_manager_torch.analysis``) in
   subprocesses from the repository root, over a copy of the package,
   ``deployments/`` and ``scenarios/`` (the default surface, manifests
   and the SLO cross-check on): exit 0 with no new finding and no stale
   baseline entry, cold and again warm with ``--cache``; then, with the
   ``with _DISPATCH_LOCK:`` of ``plan._eval_fn``'s ``run`` turned into
   ``if True:`` in the copy, exit 1 with error-level
   ``unserialized-dispatch`` results in its SARIF. The kernel-launch
   pass's inventory (``analysis/launchflow.py``) covers every kernel
   phases 1-13 and 15 launched, and every launch site it found outside
   ``kernels/`` holds the lock or a pragma (the ``analysis`` line:
   wall seconds, modules scanned, pragma'd sites per family, the
   inventory, the card's name and power limit). It launches no kernel.
15. (Run before phase 14.) K6, the batched RS256 verification, against
   its plain version (Python's ``pow``) over a group plan's batch on the
   ``cvm5k`` fleet (~9 550 signatures under 2048-bit keys, half of them
   valid), then timed, with its bound by the 32-bit multiply-adds its
   function needs at the card's top SM clock (the ``k6`` line); then K6
   on its own path: ``Rollout(kube, "on", dry_run=True).run()`` over the
   ``cvm5k`` fleet cut to 1,000 nodes (both tokens on every document,
   the configuration's planted shares, both JWKS files provisioned)
   launches K6 exactly once, answers every RS256 check from the batch
   (``rsa_host`` 0) and plans the groups and verdict counts of the same
   run with no batch (the ``rs256_path`` line).

``python3 chip_smoke.py --k1`` runs phases 1 and 2's K1, K1-partial and
K4 work alone, to compare two versions of K1 within one chip call.
``python3 chip_smoke.py --k2k3`` runs phase 1 and the K2 and K3 checks of
phases 2 and 8 (a) alone, with the row count where K3's one-CTA kernel
and K1's route cross (the ``k3_crossover`` line), to compare two
versions of K2 and K3 within one chip call.
``python3 chip_smoke.py --k6`` runs phases 1 and 15 alone.
``python3 chip_smoke.py --simlab`` runs phases 1 and 12 alone.
``python3 chip_smoke.py --sysfs`` runs phases 1 and 13 alone.
``python3 chip_smoke.py --analysis`` runs phase 14 alone, its inventory
held to every launch counter.
``python3 chip_smoke.py --multi-card`` runs phase 8 (e) alone, on every
visible card (it fails with one). Phases 1-7 run on one shard
(``TPU_CC_PLANNER_MESH=1``). Launch counts
are set to 0 just before phase 3 and read just after phase 5, set to 0
again just before phase 7 and read just after it, again just before
phase 8's (b) and read just after its (d), again just before phase 9
and read just after it, again just before phase 10 and read just after
it, again just before phase 11 and read just after it, again just
before phase 12 and read just after it, again just before phase
13's probe (d) and read just after it, again just before phase 15's
rollout and read just after it, and again just before phase 14,
which must launch none: each kernel
must have been launched on its path (on phase 9's, K5 and K1 or K3; on
phase 10's, K1, K2 and K5; on phase 11's, K1 from every shard and
region shard, K2 and K5; on phase 12's, K1 and K2; on phase 13's, K5
exactly once; on phase 15's, K6 exactly once), K2 exactly once per
card per incremental tick
or scan (on phase 11's, per row-writing tick of each shard session), K3
once per ``entry()`` call and, in the dry run, once per card plus the
cross-check, and on the paths of phases 10 and 11 K5 once per card per
flip. Lines before the last are findings (one JSON
object each), the ``{"kernels": [...]}`` line and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``, whose
``count`` is 1 (the cards this run drives) and, under ``--multi-card``,
the number of visible cards.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import hashlib
import io
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

#: where the kernels run
DEVICE = torch.device("cuda", 0)
#: the main path's fleet sizes (bench.py's planner tiers)
FLEET_NODES = 100_000
SESSION_NODES = 1_000_000
SLICE_HOSTS = 16
N_POOLS = 8
DELTA_RATE = 0.01
INCR_TICKS = 4
#: timing: warm-up calls, then the median of this many event-timed calls
WARM, REPS = 3, 25
#: cycles the card spins before each timed call, so the host has queued
#: the whole call before the start event runs (device time only)
SPIN_CYCLES = 4_000_000
#: the int32 compares, selects and adds K1 does per row, counted from
#: csrc/fleet_tick.cu (histogram selects included)
K1_OPS_PER_ROW = 64
#: the H100 SXM data sheet's rate outside the tensor cores (67 T/s of
#: float32); K1, K3 and K4 are scalar integer work there
PEAK_SCALAR_OPS = 67e12
#: phase 8: the mesh's shard count, and the fleet of the --once CLI run
MESH_SHARDS = 8
CLI_NODES = 1_000
MESH_INCR_TICKS = 3

ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def finding(**kw: Any) -> None:
    print(json.dumps(kw, sort_keys=True), flush=True)


def device_ms(fn: Callable[[], Any]) -> float:
    """Median device time of ``fn`` in ms over REPS event-timed calls."""
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def max_abs_err(a: Dict[str, torch.Tensor],
                b: Dict[str, torch.Tensor]) -> int:
    """Largest |a - b| over every output; raises unless the two dicts
    have the same keys, dtypes and shapes."""
    require(set(a) == set(b), f"keys differ: {sorted(a)} / {sorted(b)}")
    worst = 0
    for key in a:
        require(a[key].dtype == b[key].dtype
                and a[key].shape == b[key].shape,
                f"{key}: {a[key].dtype}{tuple(a[key].shape)} vs "
                f"{b[key].dtype}{tuple(b[key].shape)}")
        diff = (a[key].long() - b[key].long()).abs()
        worst = max(worst, int(diff.max()) if diff.numel() else 0)
    return worst


# ------------------------------------------------------------ inputs


def bench_columns(n: int, nb: int, n_pools: int, pb: int, now: int,
                  seed: int, slice_stride: int = 1) -> np.ndarray:
    """The planner bench's mode mix (bench.py run_planner_tick_bench):
    ~3 % divergent, ~0.2 % failed, 1 % tainted, 0.5 % failing doctors,
    evidence ages 0-7,200 s, 16-host slices. ``slice_stride`` > 1 leaves
    empty slots between used ones. Returns the [8, nb] block."""
    from tpu_cc_manager_torch.plan import DOCTOR_FAILING, DOCTOR_OK, MODE_CODES

    rng = np.random.default_rng(seed)
    on = MODE_CODES["on"]
    cols = np.zeros((8, nb), np.int32)
    cols[0, :n] = on
    cols[1, :n] = on
    cols[1, :n][rng.random(n) < 0.03] = MODE_CODES["off"]
    cols[1, :n][rng.random(n) < 0.002] = MODE_CODES["failed"]
    cols[2] = nb - 1
    cols[2, :n] = (np.arange(n) // SLICE_HOSTS) * slice_stride
    cols[3] = pb - 1 if n_pools > 1 else 0
    cols[3, :n] = np.arange(n) % n_pools
    cols[4, :n] = rng.random(n) < 0.01
    cols[5, :n] = np.where(rng.random(n) < 0.005, DOCTOR_FAILING, DOCTOR_OK)
    cols[6] = -1
    cols[6, :n] = now - rng.integers(0, 7200, n)
    cols[7, :n] = 1
    return cols


def hostile_columns(nb: int, pb: int, seed: int) -> np.ndarray:
    """Every code and index drawn past its range, negatives included:
    the kernel must keep JAX's index rules as the plain version does."""
    rng = np.random.default_rng(seed)
    cols = np.stack([
        rng.integers(-8, 9, nb), rng.integers(-8, 9, nb),
        rng.integers(-2 * nb, 2 * nb, nb), rng.integers(-2 * pb, 2 * pb, nb),
        rng.integers(-2, 3, nb), rng.integers(-1, 4, nb),
        rng.integers(-5, 2_000_000, nb), rng.integers(-2, 4, nb),
    ]).astype(np.int32)
    cols[2, :4] = [-(2 ** 31), 2 ** 31 - 1, -1, nb]
    return cols


# ------------------------------------------------- phase 2: kernels


def k1_bound_ms(n: int, pb: int, slots: int, rate: float) -> Tuple[float, str]:
    read = 4 * 8 * n + 4 * pb
    written = 7 * n + 2 * slots + 4 * (2 * 6 + 6 * pb)
    t_bytes = (read + written) / rate
    t_ops = n * K1_OPS_PER_ROW / PEAK_SCALAR_OPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


#: K1's launches, by their kernel names in csrc/fleet_tick.cu
K1_LAUNCH_NAMES = ("tick_init", "tick_rows", "tick_epilogue")


def launch_split(fn: Callable[[], Any]) -> Dict[str, Any]:
    """Device ms per call of ``fn`` for each of K1's launches, from
    ``torch.profiler``'s CUDA activity over REPS calls after warm-up,
    with the launches per call. Empty when the profiler saw no device
    time (the caller then reports the split as not measured)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    split: Dict[str, Any] = {}
    for evt in prof.key_averages():
        name = next((k for k in K1_LAUNCH_NAMES if k in evt.key), None)
        total_us = getattr(evt, "device_time_total", 0.0)
        if name is None or not total_us:
            continue
        split[f"{name}_ms"] = split.get(f"{name}_ms", 0.0) + (
            total_us / 1e3 / REPS)
        split[f"{name}_launches"] = split.get(f"{name}_launches", 0) + (
            evt.count / REPS)
    if split:
        split["sum_ms"] = sum(v for k, v in split.items()
                              if k.endswith("_ms"))
    return split


def device_block(cols: np.ndarray, offset: int = 0) -> torch.Tensor:
    """``cols`` on the card as a contiguous block that starts ``offset``
    int32 into its storage: offset 1 leaves the block 4-byte aligned
    only, which sends K1's row pass down its scalar path."""
    buf = torch.empty(cols.size + offset, dtype=torch.int32, device=DEVICE)
    block = buf[offset:].view(cols.shape)
    block.copy_(torch.from_numpy(cols))
    return block


#: the K1 cases whose launches are timed one by one (the main path's
#: shapes)
K1_SPLIT_CASES = ("nb1048576_pb8", "nb131072_pb8", "nb131072_pb16")


def check_k1(rate: float) -> List[dict]:
    from tpu_cc_manager_torch.kernels.fleet_tick import (
        fleet_tick_block, fleet_tick_reference)
    from tpu_cc_manager_torch.plan import MODE_CODES, bucket_nodes, bucket_pools

    now, stale = int(time.time()), 3600
    fleet_nb = bucket_nodes(FLEET_NODES)
    session_nb = bucket_nodes(SESSION_NODES)
    agent_nb = bucket_nodes(len(AGENT_NODES))
    pool_pb = bucket_pools(N_POOLS)
    on = MODE_CODES["on"]
    # the contention cases: every row in slot 0; every row live and in
    # pool 5; a snapshot that pads 24 % of a 1M bucket onto slot nb - 1
    one_slot = bench_columns(SESSION_NODES, session_nb, 1, 8, now, 7)
    one_slot[2] = 0
    one_pool = bench_columns(session_nb, session_nb, 1, 8, now, 8)
    one_pool[3] = 5
    padded = bench_columns(session_nb * 76 // 100, session_nb, 1, 8, now, 9)
    cases = [
        # (name, block, pool targets, storage offset): the legacy fleet
        # tick at 100k (24 % padding rows on slot nb - 1, valid 0), the
        # 8-pool policy scan, the 1M session geometry, phase 9's fleet
        # scan over the agent's two nodes, a padded fleet with
        # every other slot empty, out-of-range codes and indices, the
        # contention cases, a row count that is not a multiple of 4, and
        # the 100k block at a 4-byte storage offset
        (f"nb{fleet_nb}_pb8",
         bench_columns(FLEET_NODES, fleet_nb, 1, 8, now, 1),
         np.zeros(8, np.int32), 0),
        (f"nb{fleet_nb}_pb{pool_pb}",
         bench_columns(FLEET_NODES, fleet_nb, N_POOLS, pool_pb, now, 2),
         np.full(pool_pb, on, np.int32), 0),
        (f"nb{session_nb}_pb8",
         bench_columns(SESSION_NODES, session_nb, 1, 8, now, 3),
         np.zeros(8, np.int32), 0),
        (f"nb{agent_nb}_pb8",
         bench_columns(len(AGENT_NODES), agent_nb, 1, 8, now, 11),
         np.zeros(8, np.int32), 0),
        ("padded_empty_slots",
         bench_columns(FLEET_NODES * 7 // 10, fleet_nb, 7, 8, now, 4,
                       slice_stride=2),
         np.full(8, on, np.int32), 0),
        ("hostile_nb1024", hostile_columns(1024, 8, 5),
         np.random.default_rng(6).integers(-1, 7, 8).astype(np.int32), 0),
        (f"one_slot_nb{session_nb}", one_slot, np.zeros(8, np.int32), 0),
        (f"one_pool_nb{session_nb}", one_pool, np.full(8, on, np.int32), 0),
        (f"padding_24pct_nb{session_nb}", padded, np.zeros(8, np.int32), 0),
        (f"ragged_nb{fleet_nb - 1}",
         bench_columns(FLEET_NODES, fleet_nb - 1, 1, 8, now, 10),
         np.zeros(8, np.int32), 0),
        (f"offset4_nb{fleet_nb}",
         bench_columns(FLEET_NODES, fleet_nb, 1, 8, now, 1),
         np.zeros(8, np.int32), 1),
    ]
    rows = []
    for name, cols, target_h, offset in cases:
        nb, pb = cols.shape[1], target_h.shape[0]
        block = device_block(cols, offset)
        require(block.is_contiguous()
                and block.data_ptr() % 16 == (4 * offset) % 16,
                f"fleet_tick {name}: block at the wrong alignment")
        target = torch.from_numpy(target_h).to(DEVICE)
        args = (block, target, now, stale)
        kw = {"num_pools": pb, "num_slots": nb}
        got = fleet_tick_block(*args, **kw)
        torch.cuda.synchronize()
        want = fleet_tick_reference(*args, **kw)
        err = max_abs_err(got, want)
        require(err == 0, f"fleet_tick {name}: max |kernel - plain| = {err}")
        n = int((cols[7] > 0).sum())
        bound, by = k1_bound_ms(nb, pb, nb, rate)
        row = {"shape": name, "rows": nb, "valid_rows": n, "pb": pb,
               "storage_offset_bytes": 4 * offset, "max_abs_err": err,
               "ms": device_ms(lambda: fleet_tick_block(*args, **kw)),
               "plain_ms": device_ms(
                   lambda: fleet_tick_reference(*args, **kw)),
               "bound_ms": bound, "bound_by": by}
        if name in K1_SPLIT_CASES:
            row["split"] = launch_split(lambda: fleet_tick_block(*args, **kw))
        finding(kernel="fleet_tick", **row)
        rows.append(row)
        del block, got, want
    return rows


def kernels_per_call(fn: Callable[[], Any]) -> Any:
    """The device kernels one call of ``fn`` runs, from ``torch.profiler``'s
    CUDA activity over REPS calls after warm-up: their count per call and
    their names, or "not measured" when the profiler saw no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return "not measured"
    return {"kernels_per_call": len(kernels) / REPS,
            "kernel_names": sorted({e.name for e in kernels})}


def k2_bound_ms(kb: int, live: int, rate: float) -> float:
    """K2 reads every index once, and only a live slot's 8 values, which
    it writes once: 4 bytes per slot and 64 per live slot, for the whole
    mesh however many shards hold the rows."""
    return 1e3 * (4 * kb + 2 * 4 * 8 * live) / rate


def scatter_indices(nb: int, kb: int, k: int, rng: np.random.Generator,
                    must: Optional[np.ndarray] = None) -> np.ndarray:
    """``kb`` delta indices for a block of ``nb`` rows: ``k`` unique live
    rows of the session's fleet (``must`` among them), then indices no
    shard owns (a negative one, the int32 extremes, one past the end),
    then the padding index ``nb``."""
    must = np.zeros(0, np.int32) if must is None else must
    rest = np.setdiff1d(np.arange(SESSION_NODES, dtype=np.int32), must)
    idx = np.full(kb, nb, np.int32)
    idx[:k] = rng.permutation(np.concatenate(
        [must, rng.choice(rest, k - must.size, replace=False)]))
    idx[k:k + 4] = [-1, -(2 ** 31), 2 ** 31 - 1, nb + 7]
    return idx


def check_k2(rate: float) -> List[dict]:
    """K2 on one block (the session's unsharded geometry, one launch per
    incremental tick) at 64 and 16,384 delta slots, indices past both
    ends and padding included."""
    from tpu_cc_manager_torch.kernels.delta_scatter import (
        delta_scatter, delta_scatter_reference)
    from tpu_cc_manager_torch.plan import bucket_deltas, bucket_nodes

    rows = []
    nb = bucket_nodes(SESSION_NODES)
    for k in (50, int(SESSION_NODES * DELTA_RATE)):
        kb = bucket_deltas(k)
        rng = np.random.default_rng(kb)
        base = torch.from_numpy(
            rng.integers(-9, 9, (8, nb)).astype(np.int32)).to(DEVICE)
        idx_h = scatter_indices(nb, kb, k, rng)
        idx = torch.from_numpy(idx_h).to(DEVICE)
        vals = torch.from_numpy(
            rng.integers(-9, 9, (8, kb)).astype(np.int32)).to(DEVICE)
        got, want = base.clone(), base.clone()
        delta_scatter(got, idx, vals)
        torch.cuda.synchronize()
        delta_scatter_reference(want, idx, vals)
        err = max_abs_err({"block": got}, {"block": want})
        require(err == 0, f"delta_scatter kb={kb}: max |kernel - plain| = {err}")
        require(not torch.equal(got, base), "delta_scatter wrote nothing")
        ik, vk = idx[:k], vals[:, :k]
        row = {"shape": f"kb{kb}", "kb": kb, "live": k, "max_abs_err": err,
               "ms": device_ms(lambda: delta_scatter(got, idx, vals)),
               "plain_ms": device_ms(
                   lambda: delta_scatter_reference(want, idx, vals)),
               "library_ms": device_ms(
                   lambda: want.__setitem__((slice(None), ik), vk)),
               "bound_ms": k2_bound_ms(kb, k, rate), "bound_by": "bytes",
               "profile": kernels_per_call(
                   lambda: delta_scatter(got, idx, vals))}
        finding(kernel="delta_scatter", **row)
        rows.append(row)
    return rows


def hostile_plan(n: int, s: int, seed: int) -> Tuple[torch.Tensor, ...]:
    """K3's three columns with codes past N_MODES and below 0 (-7, -1, 6,
    99) and slice ids negative and past ``s``, among valid ones."""
    rng = np.random.default_rng(seed)
    codes = np.array([-7, -1, 6, 99, 0, 1, 2, 3, 4, 5], np.int32)
    desired = rng.choice(codes, n).astype(np.int32)
    observed = rng.choice(codes, n).astype(np.int32)
    slice_ids = rng.integers(-2 * s, 2 * s, n).astype(np.int32)
    slice_ids[:4] = [-(2 ** 31), 2 ** 31 - 1, -1, s]
    return tuple(torch.from_numpy(a).to(DEVICE)
                 for a in (desired, observed, slice_ids))


def k3_bound_ms(rows: int, slots: int, shards: int,
                rate: float) -> Tuple[float, str]:
    """K3 reads 12 bytes a row and writes 2 mask bytes a row, 2 verdict
    bytes a slot and 48 bytes of counts per shard."""
    t_bytes = (14 * rows + shards * (2 * slots + 48)) / rate
    t_ops = rows * K1_OPS_PER_ROW / PEAK_SCALAR_OPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_k3(rate: float) -> List[dict]:
    """K3 at ``graft_entry.entry()``'s shape, at row counts 1, 2 and 3
    past a multiple of 4, with hostile codes and slice ids, and at the
    one-CTA kernel's limits and one past each (K1's route)."""
    from tpu_cc_manager_torch.graft_entry import _example_fleet, entry
    from tpu_cc_manager_torch.kernels import fleet_tick as KF

    fn, args = entry(DEVICE)
    s = fn.keywords["num_slices"]
    cases = [(f"n{args[0].shape[0]}_s{s}", args, s)]
    for n in (257, 258, 259):
        cases.append((f"n{n}_s{s}", _example_fleet(n, s, seed=n,
                                                   device=DEVICE), s))
    cases.append((f"hostile_n1024_s{s}", hostile_plan(1024, s, 61), s))
    route = getattr(KF, "_plan_route", None)
    if route is not None:
        rows_cap, slots_cap = KF.MAX_PLAN_ROWS, KF.MAX_PLAN_SLOTS
        for n in (rows_cap, rows_cap + 1):
            cases.append((f"rows_limit_n{n}_s{s}",
                          _example_fleet(n, s, seed=62, device=DEVICE), s))
        for slots in (slots_cap, slots_cap + 1):
            cases.append((f"slots_limit_n256_s{slots}",
                          _example_fleet(256, slots, seed=63, device=DEVICE),
                          slots))
    rows = []
    for name, a, slots in cases:
        got = KF.fleet_plan(*a, num_slices=slots)
        torch.cuda.synchronize()
        want = KF.fleet_plan_reference(*a, num_slices=slots)
        err = max_abs_err(got, want)
        require(err == 0, f"fleet_plan {name}: max |kernel - plain| = {err}")
        n = int(a[0].shape[0])
        bound, by = k3_bound_ms(n, slots, 1, rate)
        row = {"shape": name, "n": n, "slots": slots,
               "route": route(n, slots) if route else "k1",
               "max_abs_err": err,
               "ms": device_ms(lambda: KF.fleet_plan(*a, num_slices=slots)),
               "plain_ms": device_ms(
                   lambda: KF.fleet_plan_reference(*a, num_slices=slots)),
               "bound_ms": bound, "bound_by": by, "library_ms": None,
               "profile": kernels_per_call(
                   lambda: KF.fleet_plan(*a, num_slices=slots))}
        finding(kernel="fleet_plan", **row)
        rows.append(row)
    return rows


#: the row counts at which K3's two routes are timed against each other
CROSSOVER_ROWS = (1_024, 2_048, 4_096, 8_192, 16_384, 32_768, 65_536,
                  131_072)


def k3_crossover() -> dict:
    """K3's one-CTA kernel against K1's route on the same columns at
    CROSSOVER_ROWS, both equal to the plain version, in two slice
    layouts: ``entry()``'s (row i in slice i % 16, 16 slots: every lane of
    a warp on its own slot) and the fleet's (16-host slices in row order,
    n / 16 slots). The first row count at which K1's multi-CTA route is
    faster, in each layout, is what the one-CTA limit ``MAX_PLAN_ROWS``
    of ``kernels/fleet_tick.py`` is set from."""
    from tpu_cc_manager_torch.graft_entry import _example_fleet
    from tpu_cc_manager_torch.kernels import fleet_tick as KF

    out: Dict[str, Any] = {"max_plan_rows": KF.MAX_PLAN_ROWS}
    for layout in ("round_robin_s16", "slices_of_16"):
        points, crossover = [], None
        for n in CROSSOVER_ROWS:
            if layout == "round_robin_s16":
                s = 16
                a = _example_fleet(n, s, seed=n, device=DEVICE)
            else:
                s = n // SLICE_HOSTS
                d, o, _ = _example_fleet(n, 1, seed=n, device=DEVICE)
                a = (d, o, torch.arange(n, dtype=torch.int32, device=DEVICE)
                     // SLICE_HOSTS)
            want = KF.fleet_plan_reference(*a, num_slices=s)
            cta = KF._launch_plan([a], s, None)[0]
            k1 = KF._plan_on_k1(*a, s)
            torch.cuda.synchronize()
            err = max(max_abs_err(cta, want), max_abs_err(k1, want))
            require(err == 0, f"fleet_plan routes, {layout} n={n}: {err}")
            point = {"n": n, "slots": s,
                     "cta_ms": device_ms(lambda: KF._launch_plan([a], s,
                                                                 None)),
                     "k1_ms": device_ms(lambda: KF._plan_on_k1(*a, s))}
            points.append(point)
            if crossover is None and point["k1_ms"] < point["cta_ms"]:
                crossover = n
        out[layout] = {"points": points, "first_n_k1_faster": crossover}
    finding(phase="k3_crossover", **out)
    return out


# ----------------------------------------------- phase 3: 100k nodes


def make_nodes(n: int, seed: int) -> List[dict]:
    """A seeded NodeList with the bench's mix, as node objects."""
    from tpu_cc_manager_torch import labels as L

    rng = np.random.default_rng(seed)
    now = int(time.time())
    observed = np.full(n, "on", object)
    observed[rng.random(n) < 0.03] = "off"
    observed[rng.random(n) < 0.002] = "failed"
    taint = rng.random(n) < 0.01
    failing = rng.random(n) < 0.005
    ages = rng.integers(0, 7200, n)
    no_evidence = rng.random(n) < 0.01
    nodes = []
    for i in range(n):
        ann = {L.DOCTOR_ANNOTATION: json.dumps(
            {"ok": False, "fail": ["iommu"], "at": "2026-10-01T00:00:00Z"}
            if failing[i] else {"ok": True})}
        if not no_evidence[i]:
            ann[L.EVIDENCE_ANNOTATION] = json.dumps({"timestamp": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime(now - int(ages[i])))})
        node = {"kind": "Node", "apiVersion": "v1", "metadata": {
            "name": f"node-{i:07d}",
            "labels": {
                L.TPU_ACCELERATOR_LABEL: "tpu-v5p-slice",
                L.CC_MODE_LABEL: "on",
                L.CC_MODE_STATE_LABEL: str(observed[i]),
                L.TPU_SLICE_LABEL: f"slice-{i // SLICE_HOSTS:06d}",
            },
            "annotations": ann,
        }, "spec": {}}
        if taint[i]:
            node["spec"]["taints"] = [{"key": L.FLIP_TAINT_KEY,
                                       "value": L.FLIP_TAINT_VALUE,
                                       "effect": L.FLIP_TAINT_EFFECT}]
        nodes.append(node)
    return nodes


def host_expectation(snap: Any, pool_rows: np.ndarray,
                     pool_target: np.ndarray, now_s: int,
                     stale_s: int) -> Dict[str, np.ndarray]:
    """The tick's outputs for the live rows, in numpy on the host:
    ``plan._row_outputs`` plus bincounts and segment min/max. Shares no
    code with the kernels or their plain versions."""
    from tpu_cc_manager_torch.plan import MODE_CODES, N_MODES, _row_outputs

    n = snap.n_nodes
    vals = {k: v[:n] for k, v in snap.columns.items()}
    out = _row_outputs(vals, pool_rows, pool_target, now_s, stale_s)
    out["mode_counts"] = np.bincount(vals["observed"], minlength=N_MODES)
    pb = pool_target.shape[0]
    out["pool_nodes"] = np.bincount(pool_rows, minlength=pb)
    for key in ("converged", "failed", "eligible"):
        out[f"pool_{key}"] = np.bincount(
            pool_rows, weights=out[key].astype(np.float64),
            minlength=pb).astype(np.int64)
    hist = np.zeros((pb, N_MODES), np.int64)
    np.add.at(hist, (pool_rows, vals["observed"]), 1)
    out["pool_skew"] = out["pool_nodes"] - hist.max(axis=1)
    seg = vals["slice_ids"]
    s = int(seg.max()) + 1
    known = vals["desired"] != MODE_CODES["unknown"]
    at = ((vals["observed"] == vals["desired"]) & known).astype(np.int32)
    red = {}
    for key, x, fill, ufunc in (
            ("d_mn", vals["desired"], 2 ** 31 - 1, np.minimum),
            ("d_mx", vals["desired"], -(2 ** 31), np.maximum),
            ("o_mn", vals["observed"], 2 ** 31 - 1, np.minimum),
            ("o_mx", vals["observed"], -(2 ** 31), np.maximum),
            ("a_mn", at, 1, np.minimum), ("a_mx", at, 0, np.maximum)):
        red[key] = np.full(s, fill, np.int64)
        ufunc.at(red[key], seg, x)
    agree = red["d_mn"] == red["d_mx"]
    out["slice_coherent"] = agree & (red["o_mn"] == red["o_mx"])
    out["slice_half_flipped"] = agree & (red["a_mn"] == 0) & (red["a_mx"] == 1)
    out["age"] = now_s - vals["ev_ts"]
    return out


def check_fleet_report(report: dict, snap: Any, now_s: int,
                       stale_s: int) -> None:
    from tpu_cc_manager_torch.plan import CODE_MODES

    n = snap.n_nodes
    exp = host_expectation(snap, np.zeros(n, np.int64),
                           np.zeros(8, np.int32), now_s, stale_s)
    names = np.array(snap.names)
    require(report["nodes"] == n, f"report nodes {report['nodes']} != {n}")
    for key in ("needs_flip", "failed", "flipping"):
        require(sorted(report[key]) == sorted(names[exp[key]].tolist()),
                f"report {key} differs from the host evaluation")
    # a row whose age sits at the threshold may cross it between the
    # kernel's clock read and this one
    firm = np.abs(exp["age"] - stale_s) > 120
    got = set(report["stale_evidence"])
    want = names[exp["stale_evidence"] & firm].tolist()
    require(set(want) <= got
            and not (got - set(names[exp["stale_evidence"]
                                     | ~firm].tolist())),
            "report stale_evidence differs from the host evaluation")
    counts = {CODE_MODES[i]: int(c) for i, c in enumerate(exp["mode_counts"])
              if c}
    require(report["mode_counts"] == counts,
            f"mode_counts {report['mode_counts']} != {counts}")
    slice_of = {v: k for k, v in snap.slice_index.items()
                if not k.startswith("__solo__/")}
    for key, mask in (("incoherent_slices", ~exp["slice_coherent"]),
                      ("half_flipped_slices", exp["slice_half_flipped"])):
        want = sorted(slice_of[i] for i in np.nonzero(mask)[0]
                      if i in slice_of)
        require(sorted(report[key]) == want,
                f"report {key} differs from the host evaluation")
    require(sorted(report["doctor"]["unreported"])
            == sorted(names[exp["doctor_unreported"]].tolist()),
            "doctor.unreported differs")
    require(sorted(d["node"] for d in report["doctor"]["failing"])
            == sorted(names[exp["doctor_failing"]].tolist()),
            "doctor.failing differs")


def pool_expectation(encoding: Any,
                     pools: List[Tuple[str, str, List[dict]]],
                     now_s: int, stale_s: int) -> Dict[str, Dict[str, int]]:
    """Each pool's counts, as ``analyze_pools`` reports them, from
    :func:`host_expectation` over the rows ``encoding`` holds: ``pools``
    is the scan's ``(name, target mode, nodes)`` list."""
    from tpu_cc_manager_torch import plan

    psnap = encoding.snapshot()
    rows = encoding.row_map()
    pool_rows = np.zeros(psnap.n_nodes, np.int64)
    for pid, (_, _, members) in enumerate(pools):
        for node in members:
            pool_rows[rows[node["metadata"]["name"]]] = pid
    target = np.zeros(plan.bucket_pools(len(pools)), np.int32)
    for pid, (_, mode, _) in enumerate(pools):
        target[pid] = plan.MODE_CODES[mode]
    exp = host_expectation(psnap, pool_rows, target, now_s, stale_s)
    return {pname: {"nodes": int(exp["pool_nodes"][pid]),
                    "converged": int(exp["pool_converged"][pid]),
                    "failed": int(exp["pool_failed"][pid]),
                    "divergent": int(exp["pool_nodes"][pid]
                                     - exp["pool_converged"][pid]),
                    "skew": int(exp["pool_skew"][pid]),
                    "eligible": int(exp["pool_eligible"][pid])}
            for pid, (pname, _, _) in enumerate(pools)}


def fleet_phase(tmp: str) -> dict:
    from tpu_cc_manager_torch import plan

    t0 = time.perf_counter()
    nodes = make_nodes(FLEET_NODES, seed=100)
    path = os.path.join(tmp, "nodes.json")
    with open(path, "w") as f:
        json.dump({"kind": "NodeList", "items": nodes}, f)
    setup_s = time.perf_counter() - t0

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = plan.main(["--from-file", path])
    cli_s = time.perf_counter() - t0
    now_s, stale_s = int(time.time()), int(plan._stale_after_s())
    require(rc == 0, f"plan.main exited {rc}")
    report = json.loads(buf.getvalue())
    enc = plan.FleetEncoding()
    enc.sync(nodes)
    snap = enc.snapshot()
    require(snap.bucket == plan.bucket_nodes(FLEET_NODES),
            f"bucket {snap.bucket}")
    check_fleet_report(report, snap, now_s, stale_s)

    pools = [(f"pool-{p}", "on", nodes[p::N_POOLS]) for p in range(N_POOLS)]
    scratch = plan.PoolScanScratch(device=DEVICE)
    t0 = time.perf_counter()
    first = plan.analyze_pools(pools, scratch=scratch)
    pools_first_s = time.perf_counter() - t0
    puts = scratch.session.stats["column_puts"]
    t0 = time.perf_counter()
    second = plan.analyze_pools(pools, scratch=scratch)
    pools_second_s = time.perf_counter() - t0
    require(first == second, "repeat pool scan changed its answer")
    require(scratch.session.stats["column_puts"] == puts,
            "repeat pool scan re-uploaded the columns")
    for pname, want in pool_expectation(scratch.encoding, pools, now_s,
                                        stale_s).items():
        require(first[pname] == want,
                f"{pname}: {first[pname]} != host {want}")
    return {"nodes": FLEET_NODES, "setup_s": setup_s, "cli_s": cli_s,
            "needs_flip": len(report["needs_flip"]),
            "half_flipped_slices": len(report["half_flipped_slices"]),
            "pool_scan_first_s": pools_first_s,
            "pool_scan_second_s": pools_second_s}


# ------------------------------------------------- phase 4: 1M nodes


def synthetic_encoding(n_nodes: int, now: Optional[int] = None) -> Any:
    """A populated FleetEncoding at bench scale without a million
    ``apply`` calls (the logic of bench.py's ``_synthetic_encoding``):
    columns, row map and slice bookkeeping stuffed directly, in the
    layout ``apply`` produces, fingerprints left empty so every delta
    re-encodes. Evidence ages count back from ``now`` (the clock when
    None). The session's first tick over it is the rebuild."""
    from tpu_cc_manager_torch import plan

    enc = plan.FleetEncoding()
    nb = plan.bucket_nodes(n_nodes)
    cols = bench_columns(n_nodes, nb, 1, 8,
                         int(time.time()) if now is None else now, seed=7)
    names = [f"n{i:07d}" for i in range(n_nodes)]
    enc._names = names
    enc._row = {name: i for i, name in enumerate(names)}
    enc._cap = nb
    enc._desired = cols[0].copy()
    enc._observed = cols[1].copy()
    sl = np.zeros(nb, np.int32)
    sl[:n_nodes] = cols[2, :n_nodes]
    enc._slice = sl
    n_slices = int(sl[n_nodes - 1]) + 1
    enc._slice_index = {f"s{j}": j for j in range(n_slices)}
    enc._slice_key_of = {j: f"s{j}" for j in range(n_slices)}
    counts = np.bincount(sl[:n_nodes], minlength=n_slices)
    enc._slice_refs = {j: int(counts[j]) for j in range(n_slices)}
    enc._slice_rows = {
        j: set(range(j * SLICE_HOSTS, min((j + 1) * SLICE_HOSTS, n_nodes)))
        for j in range(n_slices)
    }
    enc._next_slice = n_slices
    enc._taint = cols[4].copy()
    enc._doctor = cols[5].copy()
    enc._ev_ts = cols[6].copy()
    return enc


def session_phase() -> Tuple[dict, Any, Any]:
    from tpu_cc_manager_torch import labels as L
    from tpu_cc_manager_torch import plan
    from tpu_cc_manager_torch.kernels import LAUNCHES

    t0 = time.perf_counter()
    enc = synthetic_encoding(SESSION_NODES)
    setup_s = time.perf_counter() - t0
    sess = plan.TickSession(full_every=0, device=DEVICE)
    t0 = time.perf_counter()
    res = sess.tick(enc)
    rebuild_s = time.perf_counter() - t0
    require(res.kind == "rebuild", f"first tick was {res.kind}")
    rng = np.random.default_rng(11)
    k = int(SESSION_NODES * DELTA_RATE)
    scatters = LAUNCHES["delta_scatter"]
    incr = []
    for r in range(INCR_TICKS):
        state = "off" if r % 2 == 0 else "on"
        for i in rng.choice(SESSION_NODES, size=k, replace=False):
            enc.apply({"metadata": {"name": enc._names[i], "labels": {
                L.CC_MODE_LABEL: "on", L.CC_MODE_STATE_LABEL: state,
                L.TPU_SLICE_LABEL: f"s{i // SLICE_HOSTS}"}}})
        t0 = time.perf_counter()
        res = sess.tick(enc)
        incr.append(time.perf_counter() - t0)
        require(res.kind == "incremental", f"tick {r} was {res.kind}")
    require(LAUNCHES["delta_scatter"] == scatters + INCR_TICKS,
            f"{LAUNCHES['delta_scatter'] - scatters} delta_scatter launches "
            f"in {INCR_TICKS} incremental ticks on one shard, not one each")
    t0 = time.perf_counter()
    res = sess.tick(enc, force_full=True)  # raises IncrementalDriftError
    full_s = time.perf_counter() - t0
    require(res.kind == "full", f"forced tick was {res.kind}")
    total = int(res.outputs["mode_counts"].sum())
    require(total == SESSION_NODES, f"mode_counts sums to {total}")
    require(sess.stats["column_puts"] == 8, f"stats {sess.stats}")
    return {"nodes": SESSION_NODES, "bucket": sess.node_bucket,
            "setup_s": setup_s, "rebuild_tick_s": rebuild_s,
            "incremental_tick_s": incr,
            "incremental_tick_min_s": min(incr),
            "forced_full_tick_s": full_s, "delta_rows": k,
            "stats": dict(sess.stats)}, enc, sess


def split_full_tick(enc: Any, label: str) -> dict:
    """The legacy full tick (snapshot, upload, K1, fetch, report) with
    each step timed on the host clock, the second of two runs."""
    from tpu_cc_manager_torch import plan
    from tpu_cc_manager_torch.kernels.fleet_tick import fleet_tick_block

    pb = plan.BUCKET_MIN_POOLS
    target = torch.zeros(pb, dtype=torch.int32, device=DEVICE)
    for _ in range(2):
        t = {}
        t0 = time.perf_counter()
        snap = enc.snapshot()
        t["snapshot_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        block = plan.columns_to_block(snap.columns, DEVICE)
        torch.cuda.synchronize()
        t["h2d_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = fleet_tick_block(block, target, int(time.time()), 3600,
                               num_pools=pb, num_slots=snap.bucket)
        torch.cuda.synchronize()
        t["kernel_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = plan._to_host(out)
        t["d2h_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan._format_report(snap.n_nodes, snap.names, snap.slice_index,
                            snap.doctor_details, host)
        t["report_s"] = time.perf_counter() - t0
    t["total_s"] = sum(t.values())
    finding(phase="legacy_full_tick_split", fleet=label, **t)
    return t


def entry_phase() -> dict:
    from tpu_cc_manager_torch.graft_entry import entry

    fn, args = entry(DEVICE)
    out = fn(*args)
    require(int(out["mode_counts"].sum()) == 256,
            "entry(): mode_counts does not sum to 256")
    return {k: tuple(v.shape) for k, v in out.items()}


# ------------------------------------------------------ phase 6: K5


def probe_inputs(n: int, seed: int) -> np.ndarray:
    """Seeded float32 values over many magnitudes, and the values where
    rounding and IEEE rules bite (the probe's own 1.0 first)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 10.0 ** rng.integers(-40, 38, n)
    special = [1.0, 0.0, -0.0, -1.0, 2.0 ** -24, -1.0 + 2.0 ** -24, 1e-45,
               1.17e-38, 3.4e38, -3.4e38, 2.0 ** 24 + 2, np.inf, -np.inf,
               np.nan]
    return np.concatenate([np.array(special), x]).astype(np.float32)


def float_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over finite values; raises unless both have
    NaN at the same places and every other value has the same bits."""
    require(got.dtype == want.dtype == torch.float32
            and got.shape == want.shape,
            f"{got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}")
    nan = torch.isnan(want)
    require(torch.equal(torch.isnan(got), nan), "NaN positions differ")
    require(torch.equal(got[~nan].view(torch.int32),
                        want[~nan].view(torch.int32)), "bits differ")
    fin = torch.isfinite(want)
    diff = (got[fin].double() - want[fin].double()).abs()
    return float(diff.max()) if diff.numel() else 0.0


def check_k5(rate: float, tmp: str) -> List[dict]:
    from tpu_cc_manager_torch.device.cudadev import CudaBackend
    from tpu_cc_manager_torch.kernels.probe import (
        probe_add_one, probe_add_one_reference)

    one = torch.tensor(1.0, dtype=torch.float32, device=DEVICE)
    got, want = probe_add_one(one), probe_add_one_reference(one)
    torch.cuda.synchronize()
    require(float(got) == 2.0 and float(want) == 2.0,
            f"probe_add_one(1.0) = {float(got)}, plain {float(want)}")
    err = float_err(got, want)
    vec = torch.from_numpy(probe_inputs(65_536, 13)).to(DEVICE)
    vgot = probe_add_one(vec)
    torch.cuda.synchronize()
    verr = float_err(vgot, probe_add_one_reference(vec))
    require(verr == 0.0, f"probe_add_one vector: max |kernel - plain| = {verr}")
    finding(kernel="probe_add_one", shape="n65536_seeded", max_abs_err=verr)

    be = CudaBackend(state_dir=os.path.join(tmp, "probe-state"))
    for _ in range(WARM):
        be.probe_device(0)
    trips = [be.probe_device(0) for _ in range(REPS)]
    # 4 bytes read and 4 written; one add against the scalar float32 rate.
    # The bytes' time is picoseconds: a launch, microseconds, is the
    # real floor of a one-element kernel.
    t_bytes, t_ops = 8 / rate, 1 / PEAK_SCALAR_OPS
    row = {"shape": "n1", "max_abs_err": max(err, verr),
           "ms": device_ms(lambda: probe_add_one(one)),
           "plain_ms": device_ms(lambda: probe_add_one_reference(one)),
           "library_ms": device_ms(lambda: torch.add(one, 1.0)),
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "floor": "launch: the 8 bytes take picoseconds, a launch "
                    "microseconds",
           "probe_round_trip_s": statistics.median(trips),
           "probe_round_trip_min_s": min(trips),
           "probe_round_trip_max_s": max(trips)}
    finding(kernel="probe_add_one", **row)
    return [row]


# ------------------------------------------- phase 7: the flip cycle

FLIP_MODES = ("on", "off", "devtools")
FLIP_PHASES = ("enumerate", "plan", "stage", "reset", "wait_ready", "verify")


def port_cli(args: List[str], state_dir: str) -> dict:
    """``python -m tpu_cc_manager_torch <args>`` in a subprocess with the
    mode store in ``state_dir``; returns its JSON output."""
    env = dict(os.environ, TPU_CC_STATE_DIR=state_dir,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "tpu_cc_manager_torch", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    require(proc.returncode == 0,
            f"{' '.join(args)} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout)


def dev_nodes() -> Dict[str, int]:
    """Permission bits of every /dev/nvidia* node."""
    out = {}
    for name in sorted(os.listdir("/dev")):
        if name.startswith("nvidia"):
            out[name] = os.stat(os.path.join("/dev", name)).st_mode
    return out


def flip_phase(tmp: str, sess: Any, enc: Any) -> dict:
    from tpu_cc_manager_torch.device.cudadev import CudaBackend
    from tpu_cc_manager_torch.engine import ModeEngine
    from tpu_cc_manager_torch.kernels import LAUNCHES
    from tpu_cc_manager_torch.kernels.fleet_tick import fleet_tick_block
    from tpu_cc_manager_torch.trace import Tracer

    state = os.path.join(tmp, "state")
    nodes_before = dev_nodes()
    cwd_before = set(os.listdir(ROOT))
    name = torch.cuda.get_device_name(0)

    # the resident session block, evaluated at a fixed clock before the
    # resets; the same evaluation after them must agree on every output
    now, stale = int(time.time()), 3600
    target = torch.zeros(sess.pool_bucket, dtype=torch.int32, device=DEVICE)

    def resident_outputs() -> Dict[str, torch.Tensor]:
        out = fleet_tick_block(sess._shards[0], target, now, stale,
                               num_pools=sess.pool_bucket,
                               num_slots=sess.node_bucket)
        return {k: v.clone() for k, v in out.items()}

    before = resident_outputs()
    tick_before = sess.tick(enc, force_full=True)
    snap_before = {k: np.array(v) for k, v in tick_before.outputs.items()}

    t0 = time.perf_counter()
    inv = port_cli(["probe-devices"], state)
    probe_cli_s = time.perf_counter() - t0
    require(inv["backend"] == "cuda" and inv["error"] is None,
            f"probe-devices: {inv}")
    require(len(inv["devices"]) == torch.cuda.device_count() >= 1,
            f"probe-devices listed {len(inv['devices'])} devices")
    dev0 = inv["devices"][0]
    require(dev0["device_kind"] == name and dev0["cc_capable"] is True,
            f"probe-devices device 0: {dev0}")
    require(dev0["path"].startswith("cuda:")
            and len(dev0["path"].split(":")) == 4
            and dev0["path"].endswith(".0"),
            f"probe-devices path {dev0['path']!r} is not a PCI address")

    backend = CudaBackend(state_dir=state)
    durations: Dict[str, List[float]] = {}
    tracer = Tracer()
    tracer.add_sink(lambda s: durations.setdefault(s.name, []).append(s.dur_s))
    states: List[str] = []
    engine = ModeEngine(set_state_label=states.append, evict_components=False,
                        backend=backend, tracer=tracer)
    paths = [c.path for c in backend.find_tpus()[0]]
    require(paths == [d["path"] for d in inv["devices"]],
            f"backend paths {paths} differ from the CLI's")
    flips = []
    for mode in FLIP_MODES:
        durations.clear()
        gen, probes = backend.runtime_gen, LAUNCHES["probe_add_one"]
        # what the restart's empty_cache has to hand back to the driver
        reserved = torch.cuda.memory_reserved(DEVICE)
        t0 = time.perf_counter()
        ok = engine.set_mode(mode)
        flip_s = time.perf_counter() - t0
        require(ok, f"set_mode({mode!r}) failed")
        require(backend.runtime_gen == gen + 1,
                f"runtime_gen {gen} -> {backend.runtime_gen} on {mode}")
        require(LAUNCHES["probe_add_one"] >= probes + len(paths),
                f"wait_ready did not launch probe_add_one on {mode}")
        want = {p: {"cc": mode, "ici": "off"} for p in paths}
        require(engine.get_modes() == want,
                f"get_modes after {mode}: {engine.get_modes()}")
        got_cli = port_cli(["get-cc-mode"], state)
        require(got_cli == want, f"get-cc-mode after {mode}: {got_cli}")
        flip = {"mode": mode, "flip_s": flip_s,
                "probe_launches": LAUNCHES["probe_add_one"] - probes,
                "reserved_bytes_before": reserved,
                "reserved_bytes_after": torch.cuda.memory_reserved(DEVICE)}
        for ph in FLIP_PHASES:
            flip[f"{ph}_s"] = sum(durations.get(ph, []))
        finding(phase="flip", **flip)
        flips.append(flip)
    require(states == list(FLIP_MODES), f"state labels {states}")

    after = resident_outputs()
    err = max_abs_err(after, before)
    require(err == 0, f"the resident session block changed: {err}")
    tick_after = sess.tick(enc, force_full=True)  # raises on drift
    for key, want_v in snap_before.items():
        if key == "stale_evidence":  # moves with the clock at full ticks
            continue
        require(np.array_equal(np.asarray(tick_after.outputs[key]), want_v),
                f"session output {key} changed across the resets")
    require(dev_nodes() == nodes_before, "a /dev/nvidia* node changed")
    require(set(os.listdir(ROOT)) == cwd_before,
            "the flip wrote into the repository root")
    return {"devices": len(paths), "paths": paths,
            "probe_devices_cli_s": probe_cli_s, "flips": flips,
            "runtime_gen": backend.runtime_gen,
            "session_outputs_equal": True}


# ------------------------------------------------------ phase 8: the mesh


def set_mesh(shards: int) -> None:
    """The planner's shard count for the calls that follow."""
    os.environ["TPU_CC_PLANNER_MESH"] = str(shards)


def shard_blocks(cols: np.ndarray,
                 mesh: List[torch.device]) -> List[torch.Tensor]:
    rows = cols.shape[1] // len(mesh)
    return [torch.from_numpy(np.ascontiguousarray(
        cols[:, i * rows:(i + 1) * rows])).to(dev)
        for i, dev in enumerate(mesh)]


def check_mesh_kernels(rate: float) -> Tuple[List[dict], List[dict]]:
    """Phase 2: K1's partial form on each of 8 shards and K4 over the
    partials, each against its plain version, and the combine against
    the unsharded K1 over the same block; the partial form timed on the
    first shard and on the last, which holds the padding."""
    from tpu_cc_manager_torch.kernels.fleet_tick import (
        MASK_KEYS, counts_len, fleet_tick_block, fleet_tick_partial,
        fleet_tick_partial_reference)
    from tpu_cc_manager_torch.kernels.mesh_combine import (
        mesh_combine, mesh_combine_reference, mesh_sum, mesh_sum_reference)
    from tpu_cc_manager_torch.plan import MODE_CODES, bucket_nodes

    now, stale = int(time.time()), 3600
    nb, pb, shards = bucket_nodes(SESSION_NODES), 8, MESH_SHARDS
    rows = nb // shards
    # every other slot empty, 7 pools and the padding pool, padding rows
    # in the last shard, and hostile slice ids (negative, past the width)
    cols = bench_columns(SESSION_NODES, nb, 7, pb, now, 31, slice_stride=2)
    rng = np.random.default_rng(32)
    hostile = rng.choice(SESSION_NODES, 4096, replace=False)
    cols[2, hostile] = rng.integers(-2 * nb, 2 * nb, hostile.size)
    cols[2, hostile[:4]] = [-(2 ** 31), 2 ** 31 - 1, -1, nb]
    target = torch.full((pb,), MODE_CODES["on"], dtype=torch.int32,
                        device=DEVICE)
    blocks = shard_blocks(cols, [DEVICE] * shards)
    m = counts_len(pb)
    counts = torch.empty((shards, m), dtype=torch.int32, device=DEVICE)
    slots = torch.empty((shards, 6, nb), dtype=torch.int32, device=DEVICE)
    kw = {"num_pools": pb, "num_slots": nb}
    masks, err_p = [], 0
    for i, block in enumerate(blocks):
        masks.append(fleet_tick_partial(block, target, now, stale,
                                        counts=counts[i], slots=slots[i],
                                        **kw))
        torch.cuda.synchronize()
        w_masks, w_counts, w_slots = fleet_tick_partial_reference(
            block, target, now, stale, **kw)
        err_p = max(err_p, max_abs_err(
            {"masks": masks[-1], "counts": counts[i], "slots": slots[i]},
            {"masks": w_masks, "counts": w_counts, "slots": w_slots}))
    require(err_p == 0, f"fleet_tick_partial: max |kernel - plain| = {err_p}")
    untouched = int((slots[:, 0] == 2 ** 31 - 1).all(dim=0).sum())
    require(untouched > 0, "no slot is left untouched by every shard")

    got = mesh_combine(counts, slots, num_pools=pb)
    torch.cuda.synchronize()
    err = max_abs_err(got, mesh_combine_reference(counts, slots,
                                                  num_pools=pb))
    require(err == 0, f"mesh_combine: max |kernel - plain| = {err}")
    whole = fleet_tick_block(torch.from_numpy(cols).to(DEVICE), target, now,
                             stale, **kw)
    mask = torch.cat(masks, dim=1)
    got.update({key: mask[j] for j, key in enumerate(MASK_KEYS)})
    err_whole = max_abs_err(got, whole)
    require(err_whole == 0,
            f"8 partials + mesh_combine vs K1 unsharded: {err_whole}")

    partial_read = 4 * 8 * rows + 4 * pb
    partial_written = 7 * rows + 4 * m + 4 * 6 * nb
    t_bytes = (partial_read + partial_written) / rate
    t_ops = rows * K1_OPS_PER_ROW / PEAK_SCALAR_OPS
    partials = []
    # shard 0 holds no padding; the last shard holds the 48,576 padding
    # rows (slot nb - 1, valid 0), all on one slot
    for i, where in ((0, "first"), (shards - 1, "last_padded")):
        b, c, sl = blocks[i], counts[i], slots[i]

        def call(b=b, c=c, sl=sl) -> None:
            fleet_tick_partial(b, target, now, stale, counts=c, slots=sl,
                               **kw)

        partial = {
            "shape": f"rows{rows}_slots{nb}_pb{pb}_{where}", "rows": rows,
            "slots": nb, "pb": pb, "shards": shards, "shard": i,
            "padding_rows": int((cols[7, i * rows:(i + 1) * rows] == 0).sum()),
            "max_abs_err": err_p, "ms": device_ms(call),
            "plain_ms": device_ms(lambda b=b: fleet_tick_partial_reference(
                b, target, now, stale, **kw)),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "split": launch_split(call)}
        finding(kernel="fleet_tick_partial", **partial)
        partials.append(partial)

    read = 4 * shards * (6 * nb + m)
    written = 4 * (m + 2 * pb) + 2 * nb
    t_bytes = (read + written) / rate
    t_ops = (6 * shards * nb + shards * m) / PEAK_SCALAR_OPS
    combine = {
        "shape": f"s{shards}_slots{nb}_pb{pb}", "rows": nb, "shards": shards,
        "pb": pb, "untouched_slots": untouched, "max_abs_err": err,
        "max_abs_err_vs_unsharded_k1": err_whole,
        "bytes_read": read, "bytes_written": written,
        "ms": device_ms(lambda: mesh_combine(counts, slots, num_pools=pb)),
        "plain_ms": device_ms(lambda: mesh_combine_reference(
            counts, slots, num_pools=pb)),
        "library_ms": device_ms(lambda: (
            counts.sum(dim=0), slots.amin(dim=0), slots.amax(dim=0))),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    finding(kernel="mesh_combine", **combine)

    # the counts-only form at the dry run's shape, sums that wrap included
    part = torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31 - 1, (shards, 6)).astype(np.int32)).to(DEVICE)
    sums = mesh_sum(part)
    torch.cuda.synchronize()
    err_sum = max_abs_err({"sum": sums}, {"sum": mesh_sum_reference(part)})
    require(err_sum == 0, f"mesh_sum: max |kernel - plain| = {err_sum}")
    t_bytes = 4 * (shards * 6 + 6) / rate
    counts_only = {
        "shape": f"s{shards}_m6_counts_only", "rows": 6, "shards": shards,
        "max_abs_err": err_sum,
        "ms": device_ms(lambda: mesh_sum(part)),
        "plain_ms": device_ms(lambda: mesh_sum_reference(part)),
        "library_ms": device_ms(lambda: part.sum(dim=0)),
        "bound_ms": 1e3 * max(t_bytes, shards * 6 / PEAK_SCALAR_OPS),
        "bound_by": "bytes"}
    finding(kernel="mesh_combine", **counts_only)
    del blocks, counts, slots, masks, got, whole, mask
    torch.cuda.empty_cache()
    return partials, [combine, counts_only]


def scatter_shards(blocks: List[torch.Tensor], idx: torch.Tensor,
                   vals: torch.Tensor, nb: int) -> None:
    """K2 over the shard blocks of one card: one launch of
    ``delta_scatter_shards``; a package without that form (the one
    before it) loops the one-block call over the shards."""
    from tpu_cc_manager_torch.kernels import delta_scatter as KD

    batched = getattr(KD, "delta_scatter_shards", None)
    if batched is not None:
        batched(blocks, idx, vals, nb)
        return
    rows = nb // len(blocks)
    for i, block in enumerate(blocks):
        KD.delta_scatter(block, idx, vals, row0=i * rows)


def plan_shards(calls: List[Tuple[torch.Tensor, ...]], num_slices: int,
                partial: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
    """K3 over the shards of one card, each shard's mode histogram in its
    row of ``partial``: one launch of ``fleet_plan_shards``; a package
    without that form loops ``fleet_plan`` and copies each row."""
    from tpu_cc_manager_torch.kernels import fleet_tick as KF

    batched = getattr(KF, "fleet_plan_shards", None)
    if batched is not None:
        return batched(calls, num_slices=num_slices, mode_counts=partial)
    outs = []
    for i, cols in enumerate(calls):
        outs.append(KF.fleet_plan(*cols, num_slices=num_slices))
        partial[i].copy_(outs[-1]["mode_counts"])
    return outs


def check_shard_kernels(rate: float) -> Tuple[List[dict], List[dict]]:
    """Phase 8 (a), the mesh's forms of K2 and K3, each against its plain
    version: K2 over the 8 shard blocks of the 1M mesh on one card (one
    launch) at kb 16,384 with the first and last row of every shard among
    the indices, indices no shard owns and padding; K3 over the dry run's
    8 shards (8 nodes, 2 local slices each) on one card (one launch, the
    mode histograms into the rows of a partial buffer) and at its
    unsharded cross-check (64 nodes, 16 slices)."""
    from tpu_cc_manager_torch.graft_entry import _example_fleet
    from tpu_cc_manager_torch.kernels.delta_scatter import (
        delta_scatter_reference)
    from tpu_cc_manager_torch.kernels.fleet_tick import (
        N_MODES, fleet_plan, fleet_plan_reference)
    from tpu_cc_manager_torch.plan import bucket_deltas, bucket_nodes

    nb, shards = bucket_nodes(SESSION_NODES), MESH_SHARDS
    rows = nb // shards
    k = int(SESSION_NODES * DELTA_RATE)
    kb = bucket_deltas(k)
    rng = np.random.default_rng(51)
    edges = np.array([r for i in range(shards)
                      for r in (i * rows, (i + 1) * rows - 1)], np.int32)
    idx_h = scatter_indices(nb, kb, k, rng, must=edges)
    idx = torch.from_numpy(idx_h).to(DEVICE)
    vals = torch.from_numpy(
        rng.integers(-9, 9, (8, kb)).astype(np.int32)).to(DEVICE)
    base = [torch.from_numpy(rng.integers(-9, 9, (8, rows)).astype(
        np.int32)).to(DEVICE) for _ in range(shards)]
    got = [b.clone() for b in base]
    want = [b.clone() for b in base]
    scatter_shards(got, idx, vals, nb)
    torch.cuda.synchronize()
    library = []
    for i in range(shards):
        delta_scatter_reference(want[i], idx, vals, row0=i * rows)
        require(torch.equal(got[i][:, [0, -1]], vals[:, [
            int(np.nonzero(idx_h == i * rows + r)[0][0])
            for r in (0, rows - 1)]]), f"shard {i}: an edge row was lost")
        live = (idx_h >= i * rows) & (idx_h < (i + 1) * rows)
        sel = torch.from_numpy(np.nonzero(live)[0]).to(DEVICE)
        library.append((want[i], idx[sel].long() - i * rows, vals[:, sel]))
    err = max_abs_err({f"block{i}": g for i, g in enumerate(got)},
                      {f"block{i}": w for i, w in enumerate(want)})
    require(err == 0, f"delta_scatter on shards: max |kernel - plain| = {err}")

    def plain() -> None:
        for i, block in enumerate(want):
            delta_scatter_reference(block, idx, vals, row0=i * rows)

    k2 = {"shape": f"kb{kb}_{shards}x{rows}", "kb": kb, "live": k,
          "shards": shards, "shard_rows": rows, "max_abs_err": err,
          "ms": device_ms(lambda: scatter_shards(got, idx, vals, nb)),
          "plain_ms": device_ms(plain),
          "library_ms": device_ms(lambda: [
              block.__setitem__((slice(None), local), v)
              for block, local, v in library]),
          "bound_ms": k2_bound_ms(kb, k, rate), "bound_by": "bytes",
          "profile": kernels_per_call(
              lambda: scatter_shards(got, idx, vals, nb))}
    finding(kernel="delta_scatter", **k2)

    per_shard, n_slices = 8, 2
    desired, observed, _ = _example_fleet(per_shard * shards, 1, seed=1,
                                          device=DEVICE)
    local_ids = torch.arange(n_slices, dtype=torch.int32, device=DEVICE
                             ).repeat_interleave(per_shard // n_slices)
    calls = [(desired[i * per_shard:(i + 1) * per_shard],
              observed[i * per_shard:(i + 1) * per_shard], local_ids)
             for i in range(shards)]
    partial = torch.empty((shards, N_MODES), dtype=torch.int32,
                          device=DEVICE)
    outs = plan_shards(calls, n_slices, partial)
    torch.cuda.synchronize()
    wants = [fleet_plan_reference(*c, num_slices=n_slices) for c in calls]
    err = max(max_abs_err(o, w) for o, w in zip(outs, wants))
    err = max(err, max_abs_err(
        {"partial": partial},
        {"partial": torch.stack([w["mode_counts"] for w in wants])}))
    require(err == 0, f"fleet_plan on {shards} shards: max |kernel - plain| "
            f"= {err}")
    bound, by = k3_bound_ms(per_shard * shards, n_slices, shards, rate)
    batch = {"shape": f"n{per_shard}_s{n_slices}_{shards}x",
             "n": per_shard * shards, "slots": n_slices, "shards": shards,
             "max_abs_err": err,
             "ms": device_ms(lambda: plan_shards(calls, n_slices, partial)),
             "plain_ms": device_ms(lambda: [
                 fleet_plan_reference(*c, num_slices=n_slices)
                 for c in calls]),
             "bound_ms": bound, "bound_by": by, "library_ms": None,
             "profile": kernels_per_call(lambda: plan_shards(calls, n_slices,
                                                     partial))}
    finding(kernel="fleet_plan", **batch)

    s = n_slices * shards
    global_ids = torch.cat([local_ids + i * n_slices for i in range(shards)])
    got3 = fleet_plan(desired, observed, global_ids, num_slices=s)
    torch.cuda.synchronize()
    err = max_abs_err(got3, fleet_plan_reference(desired, observed,
                                                 global_ids, num_slices=s))
    require(err == 0, f"fleet_plan cross-check: max |kernel - plain| = {err}")
    bound, by = k3_bound_ms(per_shard * shards, s, 1, rate)
    cross = {"shape": f"n{per_shard * shards}_s{s}",
             "n": per_shard * shards, "slots": s, "max_abs_err": err,
             "ms": device_ms(lambda: fleet_plan(desired, observed,
                                                global_ids, num_slices=s)),
             "plain_ms": device_ms(lambda: fleet_plan_reference(
                 desired, observed, global_ids, num_slices=s)),
             "bound_ms": bound, "bound_by": by, "library_ms": None}
    finding(kernel="fleet_plan", **cross)
    del got, want, base, library
    torch.cuda.empty_cache()
    return [k2], [batch, cross]


def stale_firm(ev_ts: np.ndarray, clocks: List[int], stale_s: int,
               margin: int = 120) -> np.ndarray:
    """Rows whose stale_evidence verdict cannot move between the clocks
    two runs read: their age sits more than ``margin`` seconds from the
    threshold at every one of them (or they carry no evidence)."""
    firm = np.ones(ev_ts.shape, bool)
    for now in clocks:
        firm &= (ev_ts < 0) | (np.abs(now - ev_ts.astype(np.int64)
                                      - stale_s) > margin)
    return firm


def mesh_session_phase(shards: int) -> Tuple[dict, Any, Any]:
    """Phase 8 (b): phase 4's 1M session at ``shards`` shards and at one,
    in lockstep over the same fleet and the same deltas: a rebuild,
    MESH_INCR_TICKS incremental ticks at 1 % deltas and a forced full
    tick, every output array compared after each tick. stale_evidence
    compares exactly when both sessions read the same clock, else on the
    rows no clock between them can move."""
    from tpu_cc_manager_torch import labels as L
    from tpu_cc_manager_torch import plan

    now = int(time.time())
    stale_s = int(plan._stale_after_s())
    runs = {}
    for s in (shards, 1):
        set_mesh(s)  # a session reads its mesh once, when it is made
        runs[s] = {"enc": synthetic_encoding(SESSION_NODES, now=now),
                   "sess": plan.TickSession(full_every=0, device=DEVICE),
                   "times": {"incremental_tick_s": []}}
        require(len(runs[s]["sess"].mesh) == s, "mesh size")
    ev_ts = runs[1]["enc"]._ev_ts.copy()
    rng = np.random.default_rng(41)
    k = int(SESSION_NODES * DELTA_RATE)
    kinds, exact_stale = [], 0
    for r in range(MESH_INCR_TICKS + 2):
        rows = (rng.choice(SESSION_NODES, size=k, replace=False)
                if 0 < r <= MESH_INCR_TICKS else ())
        full = r == MESH_INCR_TICKS + 1
        ticks = {}
        for s, run in runs.items():
            enc, sess, times = run["enc"], run["sess"], run["times"]
            for i in rows:
                enc.apply({"metadata": {"name": enc._names[i], "labels": {
                    L.CC_MODE_LABEL: "on",
                    L.CC_MODE_STATE_LABEL: "off" if r % 2 else "failed",
                    L.TPU_SLICE_LABEL: f"s{i // SLICE_HOSTS}"}}})
            if full:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(DEVICE)
                base = torch.cuda.memory_allocated(DEVICE)
            t0 = time.perf_counter()
            res = sess.tick(enc, force_full=full)  # raises on drift
            dt = time.perf_counter() - t0
            if r == 0:
                times["rebuild_tick_s"] = dt
            elif full:
                times["forced_full_tick_s"] = dt
                times["full_tick_peak_extra_bytes"] = (
                    torch.cuda.max_memory_allocated(DEVICE) - base)
            else:
                times["incremental_tick_s"].append(dt)
            ticks[s] = (res.kind, sess._now_s, res.outputs)
        (kind_a, now_a, out_a), (kind_b, now_b, out_b) = ticks.values()
        kinds.append(kind_a)
        require(kind_a == kind_b and set(out_a) == set(out_b),
                f"tick {r}: {kind_a} vs {kind_b}")
        exact_stale += now_a == now_b
        for key in out_a:
            x, y = np.asarray(out_a[key]), np.asarray(out_b[key])
            if key == "stale_evidence" and now_a != now_b:
                firm = stale_firm(ev_ts[:x.size], [now_a, now_b], stale_s)
                x, y = x[firm], y[firm]
            require(x.dtype == y.dtype and np.array_equal(x, y),
                    f"{shards}-shard vs 1-shard session: {key} differs on "
                    f"the {kind_a} tick {r}")
    want = ["rebuild"] + ["incremental"] * MESH_INCR_TICKS + ["full"]
    require(kinds == want, f"tick kinds {kinds}")
    out = {"nodes": SESSION_NODES, "shards": shards, "outputs_equal": True,
           "ticks_with_one_clock": exact_stale, "ticks": len(kinds)}
    for s, run in runs.items():
        sess = run["sess"]
        require(len(sess._shards) == s, f"{len(sess._shards)} shards")
        out["sharded" if s == shards else "single"] = dict(
            run["times"], stats=dict(sess.stats),
            shard_devices=[str(b.device) for b in sess._shards])
    return out, runs[shards]["sess"], runs[shards]["enc"]


def mesh_split(sess: Any) -> dict:
    """Device time of one sharded full tick over ``sess``'s resident
    shards, by part, read from CUDA events that ``plan._mesh_tick``
    records at its own stage boundaries (``plan.MESH_MARK``) on every
    card's stream, median of REPS ticks after WARM: the shards' K1
    partials (the slowest card's), the root card's wait for the partials
    on other cards and their copies, K4, and the root card's whole span.
    Each card spins before the start mark, so the host has queued the
    tick before its device time starts."""
    from tpu_cc_manager_torch import plan
    from tpu_cc_manager_torch.kernels.fleet_tick import counts_len

    shards = sess._shards
    root = shards[0].device
    run = plan._eval_fn(sess.node_bucket, sess.pool_bucket, sess.mesh)
    target = np.zeros(sess.pool_bucket, np.int32)
    marks: Dict[str, Dict[torch.device, Any]] = {}

    def mark(stage: str, cards: Tuple[torch.device, ...]) -> None:
        marks[stage] = {}
        for card in cards:
            if stage == "start":
                with torch.cuda.device(card):
                    torch.cuda._sleep(SPIN_CYCLES)
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(card))
            marks[stage][card] = event

    parts: Dict[str, List[float]] = {
        "partials_ms": [], "peer_wait_and_copy_ms": [],
        "mesh_combine_ms": [], "tick_device_ms": []}
    plan.MESH_MARK = mark
    try:
        for rep in range(WARM + REPS):
            run(shards, target, int(time.time()), 3600)
            for event in marks["combine"].values():
                event.synchronize()
            if rep < WARM:
                continue
            start, done, landed, combined = (
                marks[k] for k in ("start", "partials", "copies", "combine"))
            parts["partials_ms"].append(max(
                start[card].elapsed_time(done[card]) for card in start))
            parts["peer_wait_and_copy_ms"].append(
                done[root].elapsed_time(landed[root]))
            parts["mesh_combine_ms"].append(
                landed[root].elapsed_time(combined[root]))
            parts["tick_device_ms"].append(
                start[root].elapsed_time(combined[root]))
    finally:
        plan.MESH_MARK = None
    cards = {block.device for block in shards}
    peers = sum(block.device != root for block in shards)
    partial_bytes = 4 * (6 * sess.node_bucket + counts_len(sess.pool_bucket))
    out = {"shards": len(shards), "cards": len(cards),
           "clock": "events in plan._mesh_tick",
           "peer_copies": 2 * peers, "peer_copy_bytes": peers * partial_bytes,
           "partial_buffer_bytes": len(shards) * partial_bytes,
           **{key: statistics.median(v) for key, v in parts.items()}}
    finding(phase="mesh_tick_split", **out)
    return out


def node_ev_ts(nodes: List[dict]) -> Tuple[np.ndarray, List[str]]:
    from tpu_cc_manager_torch import plan

    enc = plan.FleetEncoding()
    enc.sync(nodes)
    snap = enc.snapshot()
    return snap.columns["ev_ts"][:snap.n_nodes], snap.names


def same_reports(a: dict, b: dict, firm_names: set, what: str) -> None:
    """Reports equal key by key; stale_evidence on the rows whose verdict
    cannot move between the two scans' clocks."""
    require(set(a) == set(b), f"{what}: report keys differ")
    for key in a:
        if key == "stale_evidence":
            require(set(a[key]) & firm_names == set(b[key]) & firm_names,
                    f"{what}: stale_evidence differs")
        elif key != "problems":
            require(a[key] == b[key], f"{what}: {key} differs")
    strip = [p for p in a["problems"] if "stale" not in p]
    require(strip == [p for p in b["problems"] if "stale" not in p],
            f"{what}: problems differ")


def write_kubeconfig(path: str, port: int) -> None:
    with open(path, "w") as f:
        f.write("apiVersion: v1\nkind: Config\ncurrent-context: smoke\n"
                "contexts: [{name: smoke, context: {cluster: local, "
                "user: dev}}]\n"
                "clusters: [{name: local, cluster: {server: "
                f"\"http://127.0.0.1:{port}\"}}}}]\n"
                "users: [{name: dev, user: {}}]\n")


def fleet_controller_phase(tmp: str, n_nodes: int = FLEET_NODES,
                           cli_nodes: int = CLI_NODES) -> dict:
    """Phase 8 (d): the fleet controller's scan at MESH_SHARDS shards and
    at one over the same FakeKube, then ``fleet-controller --once`` in a
    subprocess against a FakeApiServer."""
    from tpu_cc_manager_torch import plan
    from tpu_cc_manager_torch.fleet import FleetController
    from tpu_cc_manager_torch.k8s.apiserver import FakeApiServer
    from tpu_cc_manager_torch.k8s.fake import FakeKube

    t0 = time.perf_counter()
    nodes = make_nodes(n_nodes, seed=100)
    kube = FakeKube()
    for node in nodes:
        kube.add_node(node)
    setup_s = time.perf_counter() - t0
    stale_s = int(plan._stale_after_s())
    reports, scan_s, clocks, shards = {}, {}, [], {}
    for s in (MESH_SHARDS, 1):
        set_mesh(s)
        ctrl = FleetController(kube, port=0)
        t0 = time.perf_counter()
        reports[s] = ctrl.scan_once()
        scan_s[s] = time.perf_counter() - t0
        clocks.append(ctrl._tick_session._now_s)
        shards[s] = len(ctrl._tick_session._shards)
    require(shards == {MESH_SHARDS: MESH_SHARDS, 1: 1}, f"shards {shards}")
    ev_ts, names = node_ev_ts(nodes)
    firm = set(np.array(names)[stale_firm(ev_ts, clocks, stale_s)].tolist())
    same_reports(reports[MESH_SHARDS], reports[1], firm,
                 f"fleet scan at {MESH_SHARDS} shards vs 1")
    require(reports[1]["nodes"] == n_nodes, "fleet scan node count")

    # the CLI against a live (fake) API server, on the mesh
    srv = FakeApiServer(port=0).start()
    try:
        cli_fleet = make_nodes(cli_nodes, seed=101)
        for node in cli_fleet:
            srv.store.add_node(node)
        kubeconfig = os.path.join(tmp, "kubeconfig.yaml")
        write_kubeconfig(kubeconfig, srv.port)
        env = dict(os.environ, KUBECONFIG=kubeconfig,
                   TPU_CC_PLANNER_MESH=str(MESH_SHARDS),
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_cc_manager_torch", "fleet-controller",
             "--once"], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=300)
        cli_s = time.perf_counter() - t0
    finally:
        srv.stop()
    # exit 1 means the audit found problems (the seeded fleet has failed
    # nodes and missing evidence); anything else is a failure
    require(proc.returncode in (0, 1),
            f"fleet-controller --once exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    cli_report = json.loads(proc.stdout)
    set_mesh(1)
    local = FakeKube()
    for node in cli_fleet:
        local.add_node(node)
    ctrl = FleetController(local, port=0)
    want = ctrl.scan_once()
    ev_ts, names = node_ev_ts(cli_fleet)
    firm = set(np.array(names)[stale_firm(
        ev_ts, [ctrl._tick_session._now_s, int(time.time())],
        stale_s, margin=600)].tolist())
    same_reports(cli_report, want, firm, "fleet-controller --once")
    require(proc.returncode == (1 if want["problems"] else 0),
            "fleet-controller --once exit code vs its problems")
    return {"nodes": n_nodes, "setup_s": setup_s,
            "scan_s": {str(k): v for k, v in scan_s.items()},
            "needs_flip": len(reports[1]["needs_flip"]),
            "problems": len(reports[1]["problems"]),
            "cli_nodes": cli_nodes, "cli_s": cli_s,
            "cli_rc": proc.returncode, "reports_equal": True}


def expect_scatters(sess: Any) -> None:
    """K2 launched once per card per incremental tick in a
    :func:`mesh_session_phase` (launch counts set to 0 before it): on the
    sharded session's cards, and once on the 1-shard one."""
    from tpu_cc_manager_torch.kernels import LAUNCHES

    cards = len({block.device for block in sess._shards})
    want = MESH_INCR_TICKS * (cards + 1)
    require(LAUNCHES["delta_scatter"] == want,
            f"{LAUNCHES['delta_scatter']} delta_scatter launches in "
            f"{MESH_INCR_TICKS} incremental ticks of a {len(sess._shards)}-"
            f"shard session on {cards} card(s) and a 1-shard one, not {want}")


def dryrun_phase(shards: int) -> dict:
    """``graft_entry.dryrun_multichip(shards)`` on the card(s), with its
    launches: K3 once per card plus the cross-check, and K4 once."""
    from tpu_cc_manager_torch.graft_entry import dryrun_multichip
    from tpu_cc_manager_torch.kernels import LAUNCHES
    from tpu_cc_manager_torch.plan import _shard_devices

    cards = len(set(_shard_devices(DEVICE, shards)))
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    needs_flip, mode_counts, coherent = dryrun_multichip(shards, DEVICE)
    seconds = time.perf_counter() - t0
    launches = {key: LAUNCHES[key] - before[key] for key in LAUNCHES}
    require(launches["fleet_plan"] == cards + 1
            and launches["mesh_combine"] == 1,
            f"dry run over {shards} shards on {cards} card(s) launched "
            f"{launches}: K3 once per card plus the cross-check, K4 once")
    dryrun = {"shards": shards, "cards": cards, "seconds": seconds,
              "launches": launches, "mode_counts": mode_counts.tolist(),
              "needs_flip": int(needs_flip.sum()),
              "slices_coherent": int(coherent.sum())}
    finding(phase="dryrun_multichip", **dryrun)
    return dryrun


def mesh_phase(rate: float, tmp: str) -> Tuple[dict, Dict[str, int]]:
    """Phase 8 (b) to (e); launch counts from 0 before (b) to after
    (d)."""
    from tpu_cc_manager_torch.device.cudadev import CudaBackend
    from tpu_cc_manager_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    session, sess, enc = mesh_session_phase(MESH_SHARDS)
    expect_scatters(sess)
    # the restart analog (a flip's reset) leaves the resident shard
    # blocks as they were, and the session still verifies after it
    before = [block.clone() for block in sess._shards]
    backend = CudaBackend(state_dir=os.path.join(tmp, "mesh-state"))
    backend.find_tpus()
    backend.teardown_runtime()
    require(all(torch.equal(a, b) for a, b in zip(before, sess._shards)),
            "the restart analog changed a resident shard block")
    require(sess.tick(enc, force_full=True).kind == "full",
            "the sharded session did not verify after the restart analog")
    del before
    session["verified_after_reset"] = True
    finding(phase="mesh_session", **session)
    dryrun = dryrun_phase(MESH_SHARDS)
    fleet = fleet_controller_phase(tmp)
    finding(phase="fleet_controller", **fleet)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    split = mesh_split(sess)
    del sess
    multi = multi_card_phase()
    set_mesh(1)
    return {"session": session, "dryrun": dryrun, "fleet": fleet,
            "split": split, "multi_card": multi}, launches


def multi_card_phase() -> dict:
    """Phase 8 (e): with two cards or more, (b) again at 2 shards per
    card over every card, with the split of one sharded full tick (peer
    copies included); with one card, a finding that says why not."""
    cards = torch.cuda.device_count()
    if cards < 2:
        multi = {"ran": False,
                 "why": f"{cards} CUDA device visible: phase (e) spreads "
                        "2 shards per card over two cards or more"}
    else:
        from tpu_cc_manager_torch.kernels import reset_launches

        reset_launches()
        multi, sess, _ = mesh_session_phase(2 * cards)
        expect_scatters(sess)
        multi["split"] = mesh_split(sess)
        multi["dryrun"] = dryrun_phase(2 * cards)
        multi["ran"] = True
    finding(phase="mesh_multi_card", cards=cards, **multi)
    return multi


# ------------------------------------------------- phase 9: the node agent

#: the agent's desired modes, in order, one reconcile each
AGENT_MODES = ("on", "off", "devtools")
#: GPU-consuming pods per node: one per GPU slot of an HGX H100 node
AGENT_PODS = 8
#: the tracer spans printed per reconcile: the whole reconcile, the flip
#: taint, the drain, each card's flip and holder scan, the six engine
#: phases of phase 7 and the evidence build
AGENT_SPANS = ("reconcile", "taint_set", "evict", "reschedule",
               "taint_clear", "flip", "holder_check") + FLIP_PHASES + (
                   "evidence_build",)
#: seconds the long-lived agent may take to exit after SIGTERM
SIGTERM_TIMEOUT_S = 30
#: seconds to wait for a publication the agent defers (evidence, doctor)
PUBLISH_WAIT_S = 15
AGENT_NODE, OTHER_NODE = "h100-node-0", "h100-node-1"
#: phase 9's cluster
AGENT_NODES = (AGENT_NODE, OTHER_NODE)


#: phase 9 asks no platform identity or attestation provider: ``auto``
#: would probe a cloud metadata server
NO_PROVIDERS = {"TPU_CC_IDENTITY": "none", "TPU_CC_ATTESTATION": "none"}


@contextlib.contextmanager
def no_providers():
    """``NO_PROVIDERS`` in this process's environment, restored after."""
    keep = {k: os.environ.get(k) for k in NO_PROVIDERS}
    os.environ.update(NO_PROVIDERS)
    try:
        yield
    finally:
        for k, v in keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def gpu_pods(kube: Any, node: str, tag: str) -> None:
    from tpu_cc_manager_torch.k8s.objects import make_pod

    for i in range(AGENT_PODS):
        kube.add_pod(make_pod(f"{tag}-{i}", "default",
                              labels={"app": "gpu-job"}, node_name=node))


def pods_on(kube: Any, node: str) -> List[str]:
    return sorted(p["metadata"]["name"] for p in kube.list_pods(
        "default", field_selector=f"spec.nodeName={node}"))


def agent_nodes(kube: Any, desired: str) -> None:
    """The node the agent manages and one it must not touch, each with
    its 8 GPU pods."""
    from tpu_cc_manager_torch import labels as L
    from tpu_cc_manager_torch.k8s.objects import make_node

    for name, labels in ((AGENT_NODE, {L.CC_MODE_LABEL: desired}),
                         (OTHER_NODE, {})):
        labels[L.TPU_ACCELERATOR_LABEL] = "nvidia-h100-80gb"
        kube.add_node(make_node(name, labels=labels))
    gpu_pods(kube, OTHER_NODE, "keep")


def wait_for(pred: Callable[[], bool], timeout_s: float, what: str) -> float:
    """Poll ``pred`` until true; returns the seconds it took."""
    t0 = time.perf_counter()
    while not pred():
        require(time.perf_counter() - t0 < timeout_s,
                f"{what} within {timeout_s} s")
        time.sleep(0.02)
    return time.perf_counter() - t0


def evidence_of(node: dict) -> Optional[dict]:
    from tpu_cc_manager_torch import labels as L

    raw = (node["metadata"].get("annotations") or {}).get(
        L.EVIDENCE_ANNOTATION)
    return json.loads(raw) if raw else None


def doctor_of(node: dict) -> Optional[dict]:
    from tpu_cc_manager_torch import labels as L

    raw = (node["metadata"].get("annotations") or {}).get(
        L.DOCTOR_ANNOTATION)
    return json.loads(raw) if raw else None


def evidence_attests(node: dict, paths: List[str], mode: str) -> bool:
    doc = evidence_of(node)
    return (doc is not None
            and [d["path"] for d in doc["devices"]] == paths
            and all(d["cc"] == mode for d in doc["devices"]))


def in_process_agent(tmp: str) -> Tuple[List[dict], Any, List[str]]:
    """Phase 9 (a): ``CCManagerAgent`` over ``FakeKube`` with a node
    drain and ``CudaBackend`` on every card, driven on → off → devtools
    from this thread; each reconcile checked and timed."""
    from tpu_cc_manager_torch import labels as L
    from tpu_cc_manager_torch.agent import CCManagerAgent
    from tpu_cc_manager_torch.config import AgentConfig
    from tpu_cc_manager_torch.device.cudadev import CudaBackend
    from tpu_cc_manager_torch.k8s.fake import FakeKube
    from tpu_cc_manager_torch.kernels import LAUNCHES
    from tpu_cc_manager_torch.trace import Tracer

    backend = CudaBackend(state_dir=os.path.join(tmp, "agent-state"))
    paths = [c.path for c in backend.find_tpus()[0]]
    require(len(paths) == torch.cuda.device_count() >= 1,
            f"CudaBackend enumerated {paths}")
    kube = FakeKube()
    agent_nodes(kube, AGENT_MODES[0])
    keep = pods_on(kube, OTHER_NODE)
    # what the drain and the flip taint wrote, in order
    writes: List[Tuple[str, Any]] = []
    patch, replace = kube.patch_node, kube.replace_node

    def taints(node: dict) -> List[str]:
        return [t.get("key") for t in (node.get("spec") or {}).get(
            "taints") or []]

    def patch_node(name: str, body: dict) -> dict:
        out = patch(name, body)
        if name == AGENT_NODE and "spec" in body:
            writes.append(("spec", dict(body["spec"])))
        return out

    def replace_node(name: str, node: dict) -> dict:
        out = replace(name, node)
        if name == AGENT_NODE:
            writes.append(("taints", taints(out)))
        return out

    kube.patch_node, kube.replace_node = patch_node, replace_node

    spans: Dict[str, List[float]] = {}
    tracer = Tracer()
    tracer.add_sink(lambda s: spans.setdefault(s.name, []).append(s.dur_s))
    cfg = AgentConfig(node_name=AGENT_NODE, default_mode="on",
                      health_port=0, drain_strategy="node",
                      readiness_file=os.path.join(tmp, "agent-ready"))
    agent = CCManagerAgent(kube, cfg, backend=backend, tracer=tracer)
    agent.watcher.watch_timeout_s = 1
    agent.watcher.backoff_s = 0.05
    rcs: List[int] = []
    findings = []
    gpu_pods(kube, AGENT_NODE, "job-0")
    spans.clear()
    gen, probes = backend.runtime_gen, LAUNCHES["probe_add_one"]
    t0 = time.perf_counter()
    thread = threading.Thread(
        target=lambda: rcs.append(agent.run(max_reconciles=len(AGENT_MODES))),
        name="smoke-agent")
    thread.start()
    try:
        for step, mode in enumerate(AGENT_MODES):
            if step:
                gen, probes = backend.runtime_gen, LAUNCHES["probe_add_one"]
                del writes[:]
                spans.clear()
                gpu_pods(kube, AGENT_NODE, f"job-{step}")
                t0 = time.perf_counter()
                kube.set_node_labels(AGENT_NODE, {L.CC_MODE_LABEL: mode})
            wait_for(lambda: agent.reconcile_count > step, 60,
                     f"reconcile {step + 1} ({mode})")
            reconcile_s = time.perf_counter() - t0
            node = kube.get_node(AGENT_NODE)
            labels = node["metadata"]["labels"]
            require(labels.get(L.CC_MODE_STATE_LABEL) == mode,
                    f"state label {labels.get(L.CC_MODE_STATE_LABEL)!r} "
                    f"after the {mode} reconcile")
            want = {p: {"cc": mode, "ici": "off"} for p in paths}
            require(agent.engine.get_modes() == want,
                    f"get_modes after {mode}: {agent.engine.get_modes()}")
            cordons = [w[1].get("unschedulable") for w in writes
                       if w[0] == "spec" and "unschedulable" in w[1]]
            require(cordons[:1] == [True] and cordons[-1:] == [False],
                    f"cordon writes {cordons} during the {mode} flip")
            require(not (node.get("spec") or {}).get("unschedulable"),
                    f"the node stayed cordoned after {mode}")
            tainted = [w[1] for w in writes if w[0] == "taints"]
            require(any(L.FLIP_TAINT_KEY in t for t in tainted),
                    f"no flip taint was set during {mode}: {tainted}")
            require(L.FLIP_TAINT_KEY not in taints(node),
                    f"the flip taint stayed after {mode}")
            require(pods_on(kube, AGENT_NODE) == [],
                    f"pods left on the node after {mode}: "
                    f"{pods_on(kube, AGENT_NODE)}")
            require(pods_on(kube, OTHER_NODE) == keep,
                    f"the other node's pods changed during {mode}")
            require(backend.runtime_gen == gen + 1,
                    f"runtime_gen {gen} -> {backend.runtime_gen} on {mode}")
            launched = LAUNCHES["probe_add_one"] - probes
            require(launched >= len(paths),
                    f"{launched} probe_add_one launches for {len(paths)} "
                    f"card(s) on {mode}")
            row = {"mode": mode, "reconcile_s": reconcile_s,
                   "probe_launches": launched, "cards": len(paths),
                   "pods_evicted": AGENT_PODS}
            # host-clock span durations, summed over the cards; a span
            # the reconcile did not open is left out
            row["spans_s"] = {name: sum(spans[name]) for name in AGENT_SPANS
                              if name in spans}
            row["other_spans"] = sorted(set(spans) - set(AGENT_SPANS))
            # the evidence rides the next write or idle tick after a flip
            if step < len(AGENT_MODES) - 1:
                row["evidence_wait_s"] = wait_for(
                    lambda: evidence_attests(kube.get_node(AGENT_NODE),
                                             paths, mode),
                    PUBLISH_WAIT_S, f"evidence of {mode} naming {paths}")
            if step == 0:
                # the first idle tick's doctor self-check, published
                row["doctor_wait_s"] = wait_for(
                    lambda: doctor_of(kube.get_node(AGENT_NODE)) is not None,
                    PUBLISH_WAIT_S, "the agent's doctor verdict")
            finding(phase="agent_reconcile", **row)
            findings.append(row)
        thread.join(timeout=60)
        require(not thread.is_alive() and rcs == [0],
                f"the agent's run ended with {rcs}")
    finally:
        agent.shutdown()
        thread.join(timeout=10)
    # the final flush at shutdown carries the last flip's evidence
    require(evidence_attests(kube.get_node(AGENT_NODE), paths,
                             AGENT_MODES[-1]),
            f"final evidence {evidence_of(kube.get_node(AGENT_NODE))}")
    return findings, kube, paths


def agent_cli(args: List[str], env: Dict[str, str],
              timeout_s: float = 300) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "tpu_cc_manager_torch",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout_s)


def agent_entry_points(tmp: str) -> dict:
    """Phase 9 (b): ``set-cc-mode``, ``doctor --publish`` and the
    long-lived agent, each in a subprocess against a ``FakeApiServer``
    through a kubeconfig, on every card."""
    from tpu_cc_manager_torch import labels as L
    from tpu_cc_manager_torch.k8s.apiserver import FakeApiServer

    out: Dict[str, Any] = {}
    srv = FakeApiServer(port=0).start()
    proc = None
    try:
        store = srv.store
        agent_nodes(store, "on")
        gpu_pods(store, AGENT_NODE, "job")
        keep = pods_on(store, OTHER_NODE)
        kubeconfig = os.path.join(tmp, "agent-kubeconfig.yaml")
        write_kubeconfig(kubeconfig, srv.port)
        ready = os.path.join(tmp, "cli-agent-ready")
        env = dict(os.environ, KUBECONFIG=kubeconfig, NODE_NAME=AGENT_NODE,
                   TPU_CC_STATE_DIR=os.path.join(tmp, "cli-state"),
                   DRAIN_STRATEGY="node", CC_READINESS_FILE=ready,
                   HEALTH_PORT="0", **NO_PROVIDERS,
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        env.pop("TPU_CC_DEVICE_BACKEND", None)
        env.pop("TPU_CC_TORCH_DEVICE", None)

        t0 = time.perf_counter()
        p = agent_cli(["set-cc-mode", "-m", "on"], env)
        out["set_cc_mode_s"] = time.perf_counter() - t0
        require(p.returncode == 0,
                f"set-cc-mode exited {p.returncode}: {p.stderr[-2000:]}")
        node = store.get_node(AGENT_NODE)
        require(node["metadata"]["labels"].get(L.CC_MODE_STATE_LABEL) == "on",
                f"set-cc-mode state label {node['metadata']['labels']}")
        require(pods_on(store, AGENT_NODE) == [],
                "set-cc-mode left pods on the node")
        require(pods_on(store, OTHER_NODE) == keep,
                "set-cc-mode touched the other node's pods")
        doc = evidence_of(node)
        require(doc is not None and all(d["cc"] == "on" and
                                        d["path"].startswith("cuda:")
                                        for d in doc["devices"]),
                f"set-cc-mode evidence {doc}")

        t0 = time.perf_counter()
        p = agent_cli(["doctor", "--publish"], env)
        out["doctor_s"] = time.perf_counter() - t0
        require(p.returncode == 0,
                f"doctor exited {p.returncode}: {p.stdout[-2000:]} "
                f"{p.stderr[-2000:]}")
        report = json.loads(p.stdout)
        published = (store.get_node(AGENT_NODE)["metadata"].get(
            "annotations") or {}).get(L.DOCTOR_ANNOTATION)
        require(report["ok"] is True and published is not None
                and json.loads(published)["ok"] is True,
                f"doctor report {report}, published {published}")
        out["doctor_checks"] = sorted({c["name"] for c in report["checks"]})

        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_cc_manager_torch"], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        out["agent_ready_s"] = wait_for(
            lambda: os.path.exists(ready) or proc.poll() is not None, 120,
            "the agent's readiness file")
        require(proc.poll() is None, "the agent exited before ready")
        gpu_pods(store, AGENT_NODE, "job-agent")
        t0 = time.perf_counter()
        store.set_node_labels(AGENT_NODE, {L.CC_MODE_LABEL: "off"})
        out["agent_flip_s"] = wait_for(
            lambda: store.get_node(AGENT_NODE)["metadata"]["labels"].get(
                L.CC_MODE_STATE_LABEL) == "off", 60,
            "the agent's state label off")
        require(pods_on(store, AGENT_NODE) == [],
                "the agent left pods on the node")
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=SIGTERM_TIMEOUT_S)
        out["sigterm_exit_s"] = time.perf_counter() - t0
        log_tail = proc.stdout.read().decode()[-2000:]
        require(rc == 0, f"the agent exited {rc} on SIGTERM: {log_tail}")
        out["sigterm_timeout_s"] = SIGTERM_TIMEOUT_S
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        srv.stop()
    return out


def agent_path() -> Dict[str, int]:
    """Phase 9 with its launch counts set to 0 just before it and read
    just after it; K5 and the fleet cross-check's K1 or K3 must have
    launched."""
    from tpu_cc_manager_torch.kernels import LAUNCHES, reset_launches

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        reset_launches()
        agent = agent_phase(tmp)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    finding(phase="agent_path", launches=launches,
            **{k: v for k, v in agent.items() if k != "reconciles"})
    require(launches["probe_add_one"] > 0,
            "the agent path never launched probe_add_one")
    require(launches["fleet_tick"] + launches["fleet_plan"] > 0,
            "the fleet controller's cross-check launched neither K1 nor K3")
    return launches


@contextlib.contextmanager
def held_to_plain():
    """Every K1 and K2 launch the planner makes inside the block, from
    whatever thread, compared with its plain version on the same inputs
    (K2 on the blocks as they stood before the launch). A controller's
    scan loop logs and swallows what its scan raises
    (``FleetController.run``), so the comparison records instead of
    raising: yields the list of ``{"kernel", "shape", "max_abs_err",
    "span_ms", "thread", "t"}`` rows, one per launch, which the caller
    holds with :func:`require_plain` after the block (``max_abs_err``
    the error's text where the comparison itself failed; ``span_ms``
    CUDA events around the wrapper's call, its host-side launch work and
    any other thread's work on the stream included; ``t`` the launch on
    the host clock)."""
    from tpu_cc_manager_torch import plan
    from tpu_cc_manager_torch.kernels.delta_scatter import (
        delta_scatter_shards_reference)
    from tpu_cc_manager_torch.kernels.fleet_tick import fleet_tick_reference

    real_k1, real_k2 = plan.fleet_tick_block, plan.delta_scatter_shards
    rows: List[dict] = []

    def timed(launch: Callable[[], Any]) -> Tuple[Any, float]:
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        got = launch()
        end.record()
        end.synchronize()
        return got, start.elapsed_time(end)

    def record(kernel: str, shape: str, span_ms: float,
               compare: Callable[[], int]) -> None:
        t = time.perf_counter()
        try:
            err: Any = compare()
        except Exception as e:  # recorded, and required 0 by the caller
            err = f"{type(e).__name__}: {e}"
        rows.append({"kernel": kernel, "shape": shape, "max_abs_err": err,
                     "span_ms": span_ms,
                     "thread": threading.current_thread().name, "t": t})

    def k1(block, pool_target, now_s, stale_s, *, num_pools, num_slots):
        got, span_ms = timed(lambda: real_k1(
            block, pool_target, now_s, stale_s, num_pools=num_pools,
            num_slots=num_slots))
        record("fleet_tick", f"nb{block.shape[1]}_pb{num_pools}", span_ms,
               lambda: max_abs_err(got, fleet_tick_reference(
                   block, pool_target, now_s, stale_s, num_pools=num_pools,
                   num_slots=num_slots)))
        return got

    def k2(blocks, idx, vals, nb, *, shard_ids=None):
        want = [block.clone() for block in blocks]
        _, span_ms = timed(lambda: real_k2(blocks, idx, vals, nb,
                                           shard_ids=shard_ids))

        def compare() -> int:
            delta_scatter_shards_reference(want, idx, vals, nb,
                                           shard_ids=shard_ids)
            return max(max_abs_err({"block": got}, {"block": w})
                       for got, w in zip(blocks, want))

        record("delta_scatter", f"nb{nb}_kb{idx.shape[0]}_shards{len(blocks)}",
               span_ms, compare)

    # the planner calls both under its dispatch lock: one at a time
    plan.fleet_tick_block, plan.delta_scatter_shards = k1, k2
    try:
        yield rows
    finally:
        plan.fleet_tick_block, plan.delta_scatter_shards = real_k1, real_k2


def require_plain(rows: List[dict], where: str) -> None:
    """Every launch :func:`held_to_plain` recorded equal to its plain
    version."""
    bad = [r for r in rows if r["max_abs_err"] != 0]
    require(not bad, f"{where}: launches that differ from their plain "
                     f"versions: {bad[:3]}")


def launches_of(rows: List[dict], kernel: str) -> List[dict]:
    return [r for r in rows if r["kernel"] == kernel]


def agent_phase(tmp: str) -> dict:
    """Phase 9: the node agent on the card, (a) in process, (b) through
    its entry points, (c) as the fleet controller reads what it wrote."""
    from tpu_cc_manager_torch.device import base as device_base
    from tpu_cc_manager_torch.fleet import FleetController

    nodes_before = dev_nodes()
    cwd_before = set(os.listdir(ROOT))
    set_mesh(1)
    with no_providers():
        device_base.set_backend(None)
        try:
            reconciles, kube, paths = in_process_agent(tmp)
            entry = agent_entry_points(tmp)
            # (c) the operator's view of what the agent wrote
            verdict = doctor_of(kube.get_node(AGENT_NODE))
            require(verdict is not None and verdict["ok"] is True,
                    f"the agent's doctor verdict {verdict}")
            with held_to_plain() as held:
                t0 = time.perf_counter()
                fleet = FleetController(kube, port=0).scan_once()
                scan_s = time.perf_counter() - t0
        finally:
            device_base.set_backend(None)
    require_plain(held, "the fleet scan")
    held = launches_of(held, "fleet_tick")
    require(held, "the fleet scan launched no K1 to hold to its plain "
                  "version")
    require(AGENT_NODE not in fleet["needs_flip"]
            and AGENT_NODE not in fleet["failed"],
            f"the fleet reads {AGENT_NODE} as divergent: {fleet['needs_flip']}")
    require(fleet["problems"] == [], f"fleet problems {fleet['problems']}")
    require(AGENT_NODE not in fleet.get("stale_evidence", []),
            "the agent's evidence reads stale")
    require(AGENT_NODE not in [d["node"] for d in fleet["doctor"]["failing"]]
            and AGENT_NODE not in fleet["doctor"].get("unreported", []),
            f"doctor buckets {fleet['doctor']}")
    require(dev_nodes() == nodes_before, "a /dev/nvidia* node changed")
    require(set(os.listdir(ROOT)) == cwd_before,
            "the agent wrote into the repository root")
    return {"cards": len(paths), "paths": paths, "reconciles": reconciles,
            "entry_points": entry, "fleet_scan_s": scan_s,
            "fleet_converged": True, "fleet_scan_k1": held}


# ------------------------------- phase 10: rollout and the policy controller

#: the TPUCCPolicy pools' target modes, one per pool in turn
POLICY_TARGETS = ("on", "off", "devtools")
#: the node label that places a node in a policy's pool
POOL_LABEL = "tpu-cc-smoke/pool"
#: the share of the 100,000 nodes whose state changes between two scans
POLICY_CHURN = 0.01
#: the standard node label a rollout and a policy select the agent's
#: node by
HOSTNAME_LABEL = "kubernetes.io/hostname"
#: seconds a flip through the controllers may take
FLIP_TIMEOUT_S = 120
#: policy scans the controller may take to converge its policy
POLICY_SCANS = 20


def policy_pools(kube: Any, nodes: List[dict],
                 name_fmt: str = "pool-{}") -> List[str]:
    """Phase 10 (a)'s cluster: ``nodes`` in ``N_POOLS`` pools by the
    ``POOL_LABEL`` label, whole slices in turn, one TPUCCPolicy each,
    targets taking ``POLICY_TARGETS`` in turn; returns the policies'
    names (``name_fmt`` of the pool's index). Every pool holds failed
    nodes, so that every policy reads Degraded and the scans launch no
    rollout: they are measured alone."""
    from tpu_cc_manager_torch import labels as L

    names = [name_fmt.format(pid) for pid in range(N_POOLS)]
    members: List[List[dict]] = [[] for _ in range(N_POOLS)]
    for i, node in enumerate(nodes):
        pid = (i // SLICE_HOSTS) % N_POOLS
        node["metadata"]["labels"][POOL_LABEL] = names[pid]
        kube.add_node(node)
        members[pid].append(node)
    for pid, pool in enumerate(members):
        require(any(n["metadata"]["labels"][L.CC_MODE_STATE_LABEL]
                    == "failed" for n in pool),
                f"{names[pid]} holds no failed node")
    for pid, name in enumerate(names):
        kube.add_custom(L.POLICY_GROUP, L.POLICY_PLURAL, {
            "apiVersion": f"{L.POLICY_GROUP}/{L.POLICY_VERSION}",
            "kind": L.POLICY_KIND, "metadata": {"name": name},
            "spec": {"mode": POLICY_TARGETS[pid % len(POLICY_TARGETS)],
                     "nodeSelector": f"{POOL_LABEL}={name}"}})
    return names


#: the scans' kernels by their names in csrc/: K1's three launches, K2
SCAN_KERNEL_NAMES = K1_LAUNCH_NAMES + ("delta_scatter_kernel",)


def held_scan(fn: Callable[[], Any]) -> Tuple[Any, float, List[dict],
                                              List[dict], dict]:
    """``fn()`` with every K1 and K2 launch held to its plain version,
    under ``torch.profiler``; returns its result, its host seconds, the
    K1 and K2 rows and the device time of the port's kernels in it
    (``torch.profiler``'s CUDA activity, by kernel name: the plain
    versions' PyTorch kernels are not counted), or "not measured" when
    the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with held_to_plain() as held, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    require_plain(held, "the scan")
    return (out, host_s, launches_of(held, "fleet_tick"),
            launches_of(held, "delta_scatter"), kernel_device_time(prof))


def kernel_device_time(prof: Any) -> Any:
    """The device time and count of the scans' kernels in a finished
    ``torch.profiler`` run, by kernel name (the plain versions' PyTorch
    kernels are not counted), or "not measured" when it saw none."""
    kernels: Dict[str, Any] = {}
    for evt in prof.key_averages():
        name = next((k for k in SCAN_KERNEL_NAMES if k in evt.key), None)
        total_us = getattr(evt, "device_time_total", 0.0)
        if name is None or not total_us:
            continue
        kernels[f"{name}_ms"] = kernels.get(f"{name}_ms", 0.0) + total_us / 1e3
        kernels[f"{name}_count"] = kernels.get(f"{name}_count", 0) + evt.count
    return {"kernel_ms": sum(v for k, v in kernels.items()
                             if k.endswith("_ms")), **kernels} \
        if kernels else "not measured"


def check_policy_statuses(report: dict, encoding: Any, kube: Any,
                          names: List[str],
                          members: Optional[Dict[str, List[dict]]] = None,
                          clock: Optional[Tuple[int, int]] = None) -> None:
    """Every policy's status counts against the host evaluation of the
    rows ``encoding`` holds (the controller's scratch encoding, or one
    synced over the policies' nodes), the pools as the cluster has them
    now (``members``, pool -> nodes, where the caller keeps them), at
    ``clock`` (now and the staleness threshold, seconds; this host's if
    None)."""
    from tpu_cc_manager_torch import labels as L
    from tpu_cc_manager_torch import plan

    now_s, stale_s = clock or (int(time.time()), int(plan._stale_after_s()))
    pools = []
    for name in names:
        spec = kube.get_cluster_custom(L.POLICY_GROUP, L.POLICY_VERSION,
                                       L.POLICY_PLURAL, name)["spec"]
        pools.append((name, spec["mode"],
                      kube.list_nodes(spec["nodeSelector"]) if members is None
                      else members[name]))
    want = pool_expectation(encoding, pools, now_s, stale_s)
    for name in names:
        st = report["policies"][name]
        got = {k: st[k] for k in ("nodes", "converged", "failed",
                                  "divergent", "skew", "eligible")}
        require(got == want[name],
                f"policy {name}: status {got} != host {want[name]}")
        # a pool with failed nodes is Degraded, never rolled: the scan
        # is measured alone
        require(st["phase"] == "Degraded" and st["failed"] > 0,
                f"policy {name}: phase {st['phase']}, {st['failed']} failed")
    require("rolling" not in report,
            f"the scan rolled {report.get('rolling')}")


def pick_churn(nodes: List[dict], rng: np.random.Generator,
               count: int) -> List[Tuple[dict, str]]:
    """``count`` of ``nodes`` that are not failed, each with the state
    it flips to (on to off, anything else to on): the pools' failed
    nodes stay failed."""
    from tpu_cc_manager_torch import labels as L

    live = [n for n in nodes
            if n["metadata"]["labels"][L.CC_MODE_STATE_LABEL] != "failed"]
    out = []
    for i in rng.choice(len(live), count, replace=False):
        now = live[i]["metadata"]["labels"][L.CC_MODE_STATE_LABEL]
        out.append((live[i], "off" if now == "on" else "on"))
    return out


def churn_states(kube: Any, rng: np.random.Generator, count: int) -> None:
    """:func:`pick_churn` over the cluster's nodes, written."""
    from tpu_cc_manager_torch import labels as L

    for node, state in pick_churn(kube.list_nodes(), rng, count):
        kube.set_node_labels(node["metadata"]["name"],
                             {L.CC_MODE_STATE_LABEL: state})


#: a policy status's counts that do not depend on the clock (a node's
#: eligibility does, through its evidence's age)
POLICY_COUNTS = ("nodes", "converged", "failed", "divergent", "skew")


def policy_counts(status: dict) -> Dict[str, int]:
    return {k: status[k] for k in POLICY_COUNTS}


def policy_scan(kube: Any, names: List[str]) -> dict:
    """Phase 10 (a): ``PolicyController.scan_once`` over the 100,000
    nodes, cold (the session rebuilds) and after ``POLICY_CHURN`` of the
    nodes change state; every K1 and K2 launch held to its plain
    version, every status held to the host evaluation."""
    from tpu_cc_manager_torch.policy import PolicyController

    ctrl = PolicyController(kube, port=0)
    out: Dict[str, Any] = {"nodes": FLEET_NODES, "pools": N_POOLS,
                           "targets": list(POLICY_TARGETS)}
    rng = np.random.default_rng(10)
    stats = ctrl._pool_scratch.session.stats
    for scan in ("cold", "churn"):
        if scan == "churn":
            churn_states(kube, rng, int(FLEET_NODES * POLICY_CHURN))
        incr = stats["incr_ticks"]
        report, host_s, k1, k2, device = held_scan(ctrl.scan_once)
        # the cold scan rebuilds the session through K1; an incremental
        # scan writes its rows with K2 and reads its outputs from the
        # host mirror
        require(scan == "churn" or k1, "the cold policy scan launched no K1")
        check_policy_statuses(report, ctrl._pool_scratch.encoding, kube,
                              names)
        want_k2 = stats["incr_ticks"] - incr
        require(scan == "cold" or want_k2 == 1,
                f"the churn scan took {want_k2} incremental ticks")
        require(len(k2) == want_k2,
                f"{len(k2)} K2 launches in the {scan} scan, not one per "
                f"incremental tick ({want_k2})")
        out[scan] = {"host_s": host_s, "device": device,
                     "k1": k1, "k2": k2,
                     "launches": {"fleet_tick": len(k1),
                                  "delta_scatter": len(k2)}}
        if scan == "cold":
            out[scan]["statuses"] = {name: policy_counts(
                report["policies"][name]) for name in names}
    out["churned_nodes"] = int(FLEET_NODES * POLICY_CHURN)
    out["incr_ticks"] = stats["incr_ticks"]
    return out


def rollout_preflight(kube: Any) -> dict:
    """Phase 10 (b): ``Rollout(kube, "on", dry_run=True).run()`` over the
    100,000 nodes: its one K1 launch held to its plain version, its group
    plan counting the slices plus the solo nodes, its preflight held to
    the host evaluation."""
    from tpu_cc_manager_torch import labels as L
    from tpu_cc_manager_torch import plan
    from tpu_cc_manager_torch.rollout import Rollout

    report, host_s, k1, k2, device = held_scan(
        lambda: Rollout(kube, "on", dry_run=True).run())
    now_s, stale_s = int(time.time()), int(plan._stale_after_s())
    require(len(k1) == 1 and not k2,
            f"the preflight launched K1 {len(k1)} time(s), K2 {len(k2)}")
    nodes = kube.list_nodes()
    slices = {n["metadata"]["labels"].get(L.TPU_SLICE_LABEL) for n in nodes}
    solo = sum(1 for n in nodes
               if not n["metadata"]["labels"].get(L.TPU_SLICE_LABEL))
    want_groups = len(slices - {None}) + solo
    require(len(report.groups) == want_groups,
            f"{len(report.groups)} groups, not {want_groups} slices and "
            "solo nodes")
    require(sum(len(g.nodes) for g in report.groups) == FLEET_NODES,
            "the group plan does not cover the fleet")
    enc = plan.FleetEncoding()
    enc.sync(nodes)
    check_fleet_report(report.preflight, enc.snapshot(), now_s, stale_s)
    outcomes: Dict[str, int] = {}
    for g in report.groups:
        outcomes[g.outcome] = outcomes.get(g.outcome, 0) + 1
    return {"nodes": FLEET_NODES, "host_s": host_s, "device": device,
            "k1": k1, "groups": len(report.groups),
            "outcomes": outcomes, "failed": len(report.preflight["failed"]),
            "launches": {"fleet_tick": len(k1), "delta_scatter": len(k2)}}


@contextlib.contextmanager
def flip_agent(tmp: str, kube: Any = None, pool: Optional[str] = None):
    """Phase 10 (c)'s node: phase 9's node with its 8 GPU pods beside the
    untouched node (in ``kube``, a new ``FakeKube`` if None; with
    ``pool``, the agent's node is in that pool by ``POOL_LABEL``),
    ``CCManagerAgent`` over ``CudaBackend`` on every card with a node
    drain, running until the block ends; its first reconcile flips the
    cards to ``devtools``. Yields ``(kube, agent, backend, paths,
    spans)``."""
    from tpu_cc_manager_torch import labels as L
    from tpu_cc_manager_torch.agent import CCManagerAgent
    from tpu_cc_manager_torch.config import AgentConfig
    from tpu_cc_manager_torch.device.cudadev import CudaBackend
    from tpu_cc_manager_torch.k8s.fake import FakeKube
    from tpu_cc_manager_torch.trace import Tracer

    backend = CudaBackend(state_dir=os.path.join(tmp, "flip-state"))
    paths = [c.path for c in backend.find_tpus()[0]]
    kube = FakeKube() if kube is None else kube
    agent_nodes(kube, "devtools")
    for name in AGENT_NODES:
        kube.set_node_labels(name, {HOSTNAME_LABEL: name})
    if pool is not None:
        kube.set_node_labels(AGENT_NODE, {POOL_LABEL: pool})
    spans: Dict[str, List[float]] = {}
    tracer = Tracer()
    tracer.add_sink(lambda s: spans.setdefault(s.name, []).append(s.dur_s))
    cfg = AgentConfig(node_name=AGENT_NODE, default_mode="devtools",
                      health_port=0, drain_strategy="node",
                      readiness_file=os.path.join(tmp, "flip-ready"))
    agent = CCManagerAgent(kube, cfg, backend=backend, tracer=tracer)
    agent.watcher.watch_timeout_s = 1
    agent.watcher.backoff_s = 0.05
    gpu_pods(kube, AGENT_NODE, "job-start")
    thread = threading.Thread(target=agent.run, name="smoke-flip-agent")
    thread.start()
    try:
        wait_for(lambda: agent.reconcile_count >= 1
                 and kube.get_node(AGENT_NODE)["metadata"]["labels"].get(
                     L.CC_MODE_STATE_LABEL) == "devtools", FLIP_TIMEOUT_S,
                 "the agent's first reconcile to devtools")
        wait_for(lambda: evidence_attests(kube.get_node(AGENT_NODE), paths,
                                          "devtools"),
                 PUBLISH_WAIT_S, "evidence of devtools")
        yield kube, agent, backend, paths, spans
    finally:
        agent.shutdown()
        thread.join(timeout=30)
    require(not thread.is_alive(), "the flip agent did not stop")


def check_flip(kube: Any, agent: Any, paths: List[str], mode: str,
               keep: List[str], other_labels: dict, probes: int,
               gen: int, backend: Any) -> int:
    """The agent's node flipped to ``mode`` and the other node untouched;
    returns the K5 launches of the flip (one per card)."""
    from tpu_cc_manager_torch import labels as L
    from tpu_cc_manager_torch.kernels import LAUNCHES

    node = kube.get_node(AGENT_NODE)
    require(node["metadata"]["labels"].get(L.CC_MODE_STATE_LABEL) == mode,
            f"state label after the {mode} flip: {node['metadata']['labels']}")
    want = {p: {"cc": mode, "ici": "off"} for p in paths}
    require(agent.engine.get_modes() == want,
            f"get_modes after {mode}: {agent.engine.get_modes()}")
    require(pods_on(kube, AGENT_NODE) == [],
            f"pods left on the node after {mode}")
    other = kube.get_node(OTHER_NODE)
    require(pods_on(kube, OTHER_NODE) == keep
            and other["metadata"]["labels"] == other_labels
            and not (other.get("spec") or {}).get("unschedulable"),
            f"the other node changed during the {mode} flip")
    require(backend.runtime_gen == gen + 1,
            f"runtime_gen {gen} -> {backend.runtime_gen} on {mode}")
    launched = LAUNCHES["probe_add_one"] - probes
    require(launched == len(paths),
            f"{launched} probe_add_one launches for {len(paths)} card(s) "
            f"on the {mode} flip")
    return launched


def controller_flips(tmp: str) -> Tuple[dict, dict]:
    """Phase 10 (c): from ``devtools``, a ``Rollout`` to ``on`` with
    evidence verification, selecting the agent's node, then a TPUCCPolicy
    targeting ``devtools`` over it, reconciled by ``PolicyController``
    until healthy; each flip checked on the card, each K1 and K2 launch
    of the controllers held to its plain version."""
    from tpu_cc_manager_torch import labels as L
    from tpu_cc_manager_torch.kernels import LAUNCHES
    from tpu_cc_manager_torch.policy import PolicyController
    from tpu_cc_manager_torch.rollout import Rollout

    selector = f"{HOSTNAME_LABEL}={AGENT_NODE}"
    with flip_agent(tmp) as (kube, agent, backend, paths, spans), \
            held_to_plain() as held:
        keep = pods_on(kube, OTHER_NODE)
        other_labels = kube.get_node(OTHER_NODE)["metadata"]["labels"]

        # the rollout, judging the agent's evidence
        gpu_pods(kube, AGENT_NODE, "job-rollout")
        spans.clear()
        groups: Dict[str, float] = {}
        probes, gen = LAUNCHES["probe_add_one"], backend.runtime_gen
        t0 = time.perf_counter()
        report = Rollout(
            kube, "on", selector=selector, group_timeout_s=FLIP_TIMEOUT_S,
            poll_s=0.05, verify_evidence=True,
            on_group=lambda name, outcome, done, total: groups.setdefault(
                name, time.perf_counter() - t0)).run()
        wall_s = time.perf_counter() - t0
        require(report.ok and report.succeeded == [f"node/{AGENT_NODE}"],
                f"the rollout to on: {report.to_json()}")
        k5 = check_flip(kube, agent, paths, "on", keep, other_labels,
                        probes, gen, backend)
        rollout = {"mode": "on", "wall_s": wall_s, "group_s": groups,
                   "probe_launches": k5, "cards": len(paths),
                   "k1_held": launches_of(held, "fleet_tick"),
                   "spans_s": {k: sum(v) for k, v in spans.items()}}
        finding(phase="rollout_flip", **rollout)
        rollout_launches = len(held)

        # the policy, through the controller's own rollout
        gpu_pods(kube, AGENT_NODE, "job-policy")
        spans.clear()
        probes, gen = LAUNCHES["probe_add_one"], backend.runtime_gen
        kube.add_custom(L.POLICY_GROUP, L.POLICY_PLURAL, {
            "apiVersion": f"{L.POLICY_GROUP}/{L.POLICY_VERSION}",
            "kind": L.POLICY_KIND, "metadata": {"name": "agent-node"},
            "spec": {"mode": "devtools", "nodeSelector": selector,
                     "strategy": {"groupTimeoutSeconds": FLIP_TIMEOUT_S}}})
        ctrl = PolicyController(kube, port=0, poll_s=0.05)
        t0 = time.perf_counter()
        phases = []
        for _ in range(POLICY_SCANS):
            st = ctrl.scan_once()["policies"]["agent-node"]
            phases.append(st["phase"])
            if st["phase"] == "Converged":
                break
        wall_s = time.perf_counter() - t0
        require(phases[-1] == "Converged",
                f"the policy never converged: phases {phases}, {st}")
        k5 = check_flip(kube, agent, paths, "devtools", keep, other_labels,
                        probes, gen, backend)
        policy = {"mode": "devtools", "wall_s": wall_s, "scans": len(phases),
                  "phases": phases, "probe_launches": k5,
                  "k1_held": launches_of(held[rollout_launches:],
                                         "fleet_tick"),
                  "k2_held": launches_of(held[rollout_launches:],
                                         "delta_scatter"),
                  "cards": len(paths), "incr_ticks":
                      ctrl._pool_scratch.session.stats["incr_ticks"],
                  "spans_s": {k: sum(v) for k, v in spans.items()}}
        finding(phase="policy_flip", **policy)
    require_plain(held, "the rollout and the policy's flips")
    return rollout, policy


def controller_entry_points(tmp: str) -> dict:
    """Phase 10 (d): ``rollout -m on --dry-run`` and ``policy-controller
    --once`` in subprocesses against a ``FakeApiServer`` of ``CLI_NODES``
    converged nodes under one TPUCCPolicy."""
    from tpu_cc_manager_torch import labels as L
    from tpu_cc_manager_torch.k8s.apiserver import FakeApiServer

    out: Dict[str, Any] = {"nodes": CLI_NODES}
    srv = FakeApiServer(port=0).start()
    try:
        for node in make_nodes(CLI_NODES, seed=11):
            node["metadata"]["labels"][L.CC_MODE_STATE_LABEL] = "on"
            srv.store.add_node(node)
        srv.store.add_custom(L.POLICY_GROUP, L.POLICY_PLURAL, {
            "apiVersion": f"{L.POLICY_GROUP}/{L.POLICY_VERSION}",
            "kind": L.POLICY_KIND, "metadata": {"name": "fleet"},
            "spec": {"mode": "on",
                     "nodeSelector": L.TPU_ACCELERATOR_LABEL}})
        kubeconfig = os.path.join(tmp, "controller-kubeconfig.yaml")
        write_kubeconfig(kubeconfig, srv.port)
        env = dict(os.environ, KUBECONFIG=kubeconfig, **NO_PROVIDERS,
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        env.pop("TPU_CC_TORCH_DEVICE", None)

        t0 = time.perf_counter()
        p = agent_cli(["rollout", "-m", "on", "--dry-run"], env)
        out["rollout_dry_run_s"] = time.perf_counter() - t0
        require(p.returncode == 0,
                f"rollout --dry-run exited {p.returncode}: {p.stderr[-2000:]}")
        plan_out = json.loads(p.stdout)
        require(plan_out["ok"] is True
                and plan_out["preflight"]["nodes"] == CLI_NODES
                and sum(len(g["nodes"]) for g in plan_out["groups"])
                == CLI_NODES, f"rollout --dry-run printed {p.stdout[:2000]}")
        out["rollout_groups"] = len(plan_out["groups"])

        t0 = time.perf_counter()
        p = agent_cli(["policy-controller", "--once"], env)
        out["policy_once_s"] = time.perf_counter() - t0
        require(p.returncode == 0,
                f"policy-controller --once exited {p.returncode}: "
                f"{p.stdout[-2000:]} {p.stderr[-2000:]}")
        report = json.loads(p.stdout)
        st = report["policies"]["fleet"]
        require(report["unhealthy_policies"] == []
                and st["phase"] == "Converged"
                and st["converged"] == CLI_NODES,
                f"policy-controller --once reported {report}")
        out["policy_phase"] = st["phase"]
    finally:
        srv.stop()
    return out


def controller_path() -> Tuple[Dict[str, int], Dict[str, dict]]:
    """Phase 10 with its launch counts set to 0 just before it and read
    just after it: K1 at least once, K2 exactly once per card per
    incremental scan, K5 once per card per flip. Returns the launches and
    the cold scan's policy counts (:func:`policy_counts`), by pool
    index."""
    from tpu_cc_manager_torch import plan
    from tpu_cc_manager_torch.device import base as device_base
    from tpu_cc_manager_torch.k8s.fake import FakeKube
    from tpu_cc_manager_torch.kernels import LAUNCHES, reset_launches

    nodes_before = dev_nodes()
    cwd_before = set(os.listdir(ROOT))
    set_mesh(1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp, \
            no_providers():
        kube = FakeKube()
        names = policy_pools(kube, make_nodes(FLEET_NODES, seed=100))
        device_base.set_backend(None)
        reset_launches()
        try:
            scan = policy_scan(kube, names)
            preflight = rollout_preflight(kube)
            rollout, policy = controller_flips(tmp)
            entry = controller_entry_points(tmp)
        finally:
            device_base.set_backend(None)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    cards = len(plan._by_device(plan._planner_mesh(DEVICE)))
    incr = scan["incr_ticks"] + policy["incr_ticks"]
    finding(phase="policy_scan", **scan)
    finding(phase="rollout_preflight", **preflight)
    finding(phase="controller_entry_points", **entry)
    finding(phase="controller_path", launches=launches,
            incremental_scans=incr, flips=3)
    require(launches["fleet_tick"] > 0, "the controller path never launched "
                                        "fleet_tick")
    require(launches["delta_scatter"] == cards * incr,
            f"{launches['delta_scatter']} delta_scatter launches, not one "
            f"per card per incremental scan ({cards} x {incr})")
    # the agent's first flip to devtools, the rollout's and the policy's
    flips = 3 * rollout["cards"]
    require(launches["probe_add_one"] == flips,
            f"{launches['probe_add_one']} probe_add_one launches, not one "
            f"per card per flip ({flips})")
    require(dev_nodes() == nodes_before, "a /dev/nvidia* node changed")
    require(set(os.listdir(ROOT)) == cwd_before,
            "the controllers wrote into the repository root")
    return launches, {str(pid): scan["cold"]["statuses"][name]
                      for pid, name in enumerate(names)}


# ------------------------- phase 11: the sharded control plane

#: phase 11 (a): consistent-hash controller shards and the hosts that
#: contest their leases
SHARDS, SHARD_HOSTS = 4, 2
#: phase 11 (a)'s pool names: phase 10's (``pool-0`` ... ``pool-7``) put
#: none of the 8 on one of the 4 ring members; these put two on each
SHARD_POOL_FMT = "pool-{:02d}"
#: phase 11 (a)'s policy scan interval, the fleet controllers' default:
#: at the default 1 s each policy controller re-lists and re-encodes its
#: 25,000 nodes back to back (4-5 s a scan with all eight controllers in
#: one interpreter), and the shared informer took 138 s to hand 1,000
#: writes to every shard (PERF.md §6)
SHARD_POLICY_INTERVAL_S = 5.0
#: phase 11 (c): two regions of this many nodes in this many pools each,
#: each region's pools over this many controller shards
REGIONS = ("region-a", "region-b")
REGION_NODES = 10_000
REGION_POOLS = 4
REGION_SHARDS = 2
#: the window region-b's posture write waits, unless an evacuation
#: collapses it
REGION_B_WINDOW_S = 60.0
#: the converged checks of the zero-read pin
ZERO_READ_CHECKS = 5
#: seconds phase 11 waits for any one condition
SHARD_WAIT_S = 300
#: the node events phase 11's fake API servers retain, per node: a
#: ``FakeKube`` watch stream that lags more than its history behind the
#: writes skips the events compacted under it, with no 410 (ROADMAP
#: Queue 3), and phase 11's bursts (a region's posture write, its
#: cordon) write every node at once while the informers' subscribers
#: hold them back
WATCH_HISTORY_PER_NODE = 2


def scan_count(ctrl: Any) -> int:
    """The scans a fleet or policy controller has finished: its
    scan-duration histogram's count."""
    return ctrl.metrics.scan_duration.count


def scanned(ctrls: List[Any], more: Optional[Dict[int, int]] = None) -> bool:
    """Has every controller in ``ctrls`` finished as many scans as
    ``more`` asks of it (controller id -> scans; one where absent)?"""
    more = more or {}
    return all(scan_count(c) >= more.get(id(c), 1) for c in ctrls)


def after_now(ctrls: List[Any]) -> Dict[int, int]:
    """For :func:`scanned`: two scans past each controller's count now,
    the second of which started after now."""
    return {id(c): scan_count(c) + 2 for c in ctrls}


def scan_marks(ctrls: Dict[str, Any]) -> Dict[str, dict]:
    """Each controller's scan-duration histogram now (label ->
    ``snapshot()``), to open a window for :func:`scan_window`."""
    return {label: c.metrics.scan_duration.snapshot()
            for label, c in ctrls.items()}


def scan_window(ctrls: Dict[str, Any],
                since: Dict[str, dict]) -> Dict[str, dict]:
    """The scans each controller (label -> controller) finished since
    ``since`` (:func:`scan_marks`; from its start where absent) and
    their mean host seconds, from its own scan-duration histogram."""
    out = {}
    for label, now in scan_marks(ctrls).items():
        was = since.get(label, {"count": 0, "sum": 0.0})
        n = now["count"] - was["count"]
        if n:
            out[label] = {"scans": n,
                          "mean_s": (now["sum"] - was["sum"]) / n}
    return out


def shard_controllers(bundles: List[Any]) -> Dict[str, Any]:
    """The fleet and policy controllers of ``bundles``, by
    ``<shard>/<kind>``."""
    return {f"{b.shard_id}/{kind}": c for b in bundles
            for kind, c in (("fleet", b.fleet), ("policy", b.policy))
            if c is not None}


def shard_sessions(bundles: List[Any]) -> List[Dict[str, int]]:
    """The ``stats`` of the planner sessions of ``bundles``' controllers:
    each fleet controller's ``TickSession`` and each policy controller's
    pool-scan session."""
    out = []
    for b in bundles:
        out.append(b.fleet._tick_session.stats)
        if b.policy is not None:
            out.append(b.policy._pool_scratch.session.stats)
    return out


def merged_fleet_report(reports: List[dict]) -> dict:
    """The partition-scoped fleet reports of every shard as one report
    (counts summed, node and slice lists joined), in the shape
    :func:`check_fleet_report` reads."""
    out: Dict[str, Any] = {"nodes": 0, "mode_counts": {},
                           "doctor": {"unreported": [], "failing": []}}
    keys = ("needs_flip", "failed", "flipping", "stale_evidence",
            "incoherent_slices", "half_flipped_slices")
    for key in keys:
        out[key] = []
    for report in reports:
        out["nodes"] += report["nodes"]
        for mode, n in report["mode_counts"].items():
            out["mode_counts"][mode] = out["mode_counts"].get(mode, 0) + n
        for key in keys:
            out[key] += report[key]
        for key in ("unreported", "failing"):
            out["doctor"][key] += report["doctor"].get(key, [])
    return out


def rows_wrong(report: dict, truth: Any) -> int:
    """The nodes a shard's fleet report and the phase's own encoding of
    its partition (``truth``) disagree on: divergent in one and not in
    the other."""
    snap, rows = truth.snapshot(), truth.row_map()
    want = {n for n, i in rows.items()
            if snap.columns["desired"][i] != snap.columns["observed"][i]}
    return len(want ^ set(report["needs_flip"]))


def check_shard_reports(mgr: Any, kube: Any, truth: Dict[str, Any],
                        members: Dict[str, List[dict]]) -> dict:
    """Phase 11 (a)'s checks of the live shards: each shard's fleet
    report and each of its policies' statuses against the host
    evaluation of its partition (``truth``, shard -> the phase's own
    encoding of the partition's nodes; ``members``, pool -> the phase's
    own copy of its nodes), at the clock the shard's session froze (a
    session moves its staleness verdicts at full-tick cadence); the
    reports summed cover the fleet; the merged ``/fleet/metrics``
    fetched from the manager's port. The phase keeps its own copy of the
    cluster: a ``FakeKube`` list of 100,000 nodes holds the fake's lock
    for seconds, and every shard lease's renewal waits behind it."""
    import urllib.request

    from tpu_cc_manager_torch import fleetobs
    from tpu_cc_manager_torch.obs import validate_exposition

    bundles = mgr.bundles()
    for b in bundles:
        owned = sorted(b.pools)
        enc = truth[b.shard_id]
        sess = b.fleet._tick_session
        try:
            check_fleet_report(b.fleet.last_report, enc.snapshot(),
                               sess._now_s, sess._stale_s)
        except SmokeError as e:
            raise SmokeError(
                f"{b.shard_id}: {e}; {rows_wrong(b.fleet.last_report, enc)} "
                "nodes divergent in one of the report and the truth only"
            ) from e
        report = b.policy.last_report
        require(sorted(report["policies"]) == owned,
                f"{b.shard_id}'s policies {sorted(report['policies'])} != "
                f"its pools {owned}")
        sess = b.policy._pool_scratch.session
        check_policy_statuses(report, enc, kube, owned, members,
                              (sess._now_s, sess._stale_s))
    merged = merged_fleet_report([b.fleet.last_report for b in bundles])
    require(merged["nodes"] == FLEET_NODES,
            f"the shards' reports hold {merged['nodes']} nodes")
    with urllib.request.urlopen(
            f"http://127.0.0.1:{mgr.port}/fleet/metrics", timeout=60) as r:
        text = r.read().decode()
    problems = validate_exposition(text)
    require(problems == [], f"merged /fleet/metrics: {problems[:3]}")
    families, _ = fleetobs.parse_exposition(text)

    def gauge(name: str, labels: str = "") -> float:
        return families[name]["series"][labels]

    want = {"tpu_cc_fleet_nodes": merged["nodes"],
            "tpu_cc_fleet_needs_flip": len(merged["needs_flip"]),
            "tpu_cc_fleet_failed_nodes": len(merged["failed"]),
            "tpu_cc_shard_partitions_covered": SHARDS}
    for name, value in want.items():
        require(gauge(name) == value,
                f"/fleet/metrics {name} {gauge(name)} != {value}")
    for mode, n in merged["mode_counts"].items():
        got = gauge("tpu_cc_fleet_nodes_by_mode", f'mode="{mode}"')
        require(got == n, f"/fleet/metrics nodes_by_mode {mode} {got} != {n}")
    return {"nodes": merged["nodes"], "needs_flip": len(merged["needs_flip"]),
            "failed": len(merged["failed"]),
            "mode_counts": merged["mode_counts"], "metrics_bytes": len(text)}


def slo_pass(observer: Any, sources: List[Any]) -> dict:
    """One ``observe`` pass of phase 11 (b): every source of this pass
    scraped and valid, the merge valid and holding the fleet, no
    objective that can never fire. The sources are the manager's merged
    ``/fleet/metrics`` and each shard's own exposition, so that the
    observer's merge counts every node twice."""
    before = observer.summary()["scrapes"]
    t0 = time.perf_counter()
    merged = observer.observe(sources)
    seconds = time.perf_counter() - t0
    summary = observer.summary()
    scrapes = {k: v - before[k] for k, v in summary["scrapes"].items()}
    require(scrapes == {"ok": len(sources), "invalid": 0, "unreachable": 0},
            f"the pass's scrapes {scrapes}, of {len(sources)} sources")
    nodes = merged.get("tpu_cc_fleet_nodes", {}).get("series", {}).get("")
    require(nodes == 2 * FLEET_NODES,
            f"the observer's merge holds {nodes} nodes, not the manager's "
            f"and the shards' {FLEET_NODES} each")
    require(summary["misconfigured"] == {},
            f"SLO objectives that can never fire: {summary['misconfigured']}")
    require(observer.aggregation_problems == [],
            f"merged exposition: {observer.aggregation_problems[:3]}")
    return {"scrape_merge_s": seconds, "sources": len(sources),
            "scrapes": scrapes, "merged_nodes": nodes,
            "objectives": len(summary["objectives"]),
            "alerts": len(summary["alerts"])}


def lease_holders(kube: Any, count: int) -> List[Tuple[str, int]]:
    """(holder, transitions) of the first ``count`` shard leases."""
    from tpu_cc_manager_torch.shard import SHARD_LEASE_FMT

    out = []
    for k in range(count):
        spec = kube.get_lease("tpu-system", SHARD_LEASE_FMT.format(
            index=k))["spec"]
        out.append((spec.get("holderIdentity"),
                    int(spec.get("leaseTransitions", 0))))
    return out


def started_since(before: set) -> List[str]:
    """The threads started since ``before`` was taken that are still
    alive, by name, but for the process's one asyncio bridge
    (``k8s/aio_bridge.py``: its loop and executor threads live as long
    as the process)."""
    return sorted(t.name for t in set(threading.enumerate()) - before
                  if t.name != "cc-aio-loop"
                  and not t.name.startswith("asyncio_"))


def wake_watches(kube: Any, node: str, policy: bool) -> None:
    """After a stop: a stopped controller's watch threads (the
    informer's node watch, a policy controller's watch of its custom
    resources) stay blocked in their watch, holding their controllers,
    until its next event or its timeout (``WATCH_TIMEOUT_S``, 300 s).
    One event on each watched collection (``node``, a new policy) ends
    them."""
    from tpu_cc_manager_torch import labels as L

    kube.set_node_labels(node, {"tpu-cc-smoke/stopped": "true"})
    if policy:
        kube.add_custom(L.POLICY_GROUP, L.POLICY_PLURAL, {
            "apiVersion": f"{L.POLICY_GROUP}/{L.POLICY_VERSION}",
            "kind": L.POLICY_KIND, "metadata": {"name": "smoke-stopped"},
            "spec": {"mode": "off", "nodeSelector": "tpu-cc-smoke/none"}})


def sharded_plane(kube: Any, nodes: List[dict], names: List[str],
                  phase10: Dict[str, dict], sessions: List[Dict[str, int]],
                  out: Dict[str, Any]) -> dict:
    """Phase 11 (a) and (b): ``ShardManager`` over the 100,000 nodes in
    8 TPUCCPolicy pools, 4 shards on 2 hosts with the policy plane, the
    reference's lease settings; cold, after ``POLICY_CHURN`` of the
    nodes change, and after one host dies; the SLO observer over the
    shards' expositions around the churn. Fills ``out``, the
    ``shard_scan`` finding, as it goes, and ``sessions`` with the stats
    of every shard controller's planner session; returns the
    ``slo_observe`` finding."""
    from tpu_cc_manager_torch import labels as L
    from tpu_cc_manager_torch import plan
    from tpu_cc_manager_torch.fleetobs import (
        FleetObserver, default_slo_path, load_slo)
    from tpu_cc_manager_torch.shard import ShardManager

    out.update({"nodes": FLEET_NODES, "pools": N_POOLS, "shards": SHARDS,
                "hosts": SHARD_HOSTS,
                "policy_interval_s": SHARD_POLICY_INTERVAL_S})
    torch.cuda.synchronize()
    out["memory_before"] = torch.cuda.memory_allocated(DEVICE)
    torch.cuda.reset_peak_memory_stats(DEVICE)
    threads_before = set(threading.enumerate())
    mgr = ShardManager(lambda: kube, shards=SHARDS, hosts=SHARD_HOSTS,
                       policy=True, pools=names, pool_label=POOL_LABEL,
                       policy_interval_s=SHARD_POLICY_INTERVAL_S)
    # the host evaluation's inputs, encoded before the shards compete
    # with this thread for the interpreter: each shard's partition
    members: Dict[str, List[dict]] = {}
    for n in nodes:
        members.setdefault(n["metadata"]["labels"][POOL_LABEL], []).append(n)
    truth: Dict[str, Any] = {}
    for sid in mgr.shard_ids:
        truth[sid] = plan.FleetEncoding()
        truth[sid].sync([n for pool in mgr.pools_of(sid)
                         for n in members[pool]])
    churn = pick_churn(nodes, np.random.default_rng(11),
                       int(FLEET_NODES * POLICY_CHURN))
    t0 = time.perf_counter()
    try:
        mgr.start()
        out["start_s"] = time.perf_counter() - t0
        require(mgr.wait_covered(timeout_s=SHARD_WAIT_S),
                f"coverage {mgr.coverage()}")
        out["covered_s"] = time.perf_counter() - t0
        bundles = mgr.bundles()
        sessions += shard_sessions(bundles)
        parts = {sid: mgr.pools_of(sid) for sid in mgr.shard_ids}
        require(sorted(p for ps in parts.values() for p in ps) == sorted(names)
                and all(parts.values()),
                f"the shards' pools {parts} do not partition {names}")
        require({b.shard_id: sorted(b.pools) for b in bundles} == parts,
                f"the live shards' pools differ from the ring's {parts}")
        out["partition"] = parts
        out["coverage"] = mgr.coverage()
        ctrls = shard_controllers(bundles)
        wait_for(lambda: scanned(list(ctrls.values())), SHARD_WAIT_S,
                 "every shard's first fleet and policy scans")
        out["scanned_s"] = time.perf_counter() - t0
        out["first_check"] = check_shard_reports(mgr, kube, truth, members)
        statuses = {name: st for b in bundles
                    for name, st in b.policy.last_report["policies"].items()}
        for pid, name in enumerate(names):
            require(policy_counts(statuses[name]) == phase10[str(pid)],
                    f"{name}: {policy_counts(statuses[name])} != phase 10's "
                    f"{phase10[str(pid)]}")
        require(lease_holders(kube, SHARDS) == [
            (f"host-{k % SHARD_HOSTS}", 0) for k in range(SHARDS)],
            f"shard leases {lease_holders(kube, SHARDS)} before any failure")

        # (b) the SLO observer over the manager's merged view and every
        # shard's own exposition, before and after the churn
        observer = FleetObserver(load_slo(default_slo_path()), name="smoke")
        sources = [f"http://127.0.0.1:{mgr.port}/fleet/metrics"] + [
            b.metrics_text for b in bundles]
        slo = {"before_churn": slo_pass(observer, sources)}

        # 1 % of the nodes change; each shard session's next scans write
        # their rows with K2
        t_churn = time.perf_counter()
        at_churn = scan_marks(ctrls)
        for node, state in churn:
            meta = node["metadata"]
            kube.set_node_labels(meta["name"], {L.CC_MODE_STATE_LABEL: state})
            meta["labels"][L.CC_MODE_STATE_LABEL] = state
            truth[mgr.shard_of_pool(meta["labels"][POOL_LABEL])].apply(node)
        last = churn[-1][0]["metadata"]["name"]
        wait_for(lambda: mgr.informer.get_node(last)["metadata"]["labels"]
                 .get(L.CC_MODE_STATE_LABEL) == churn[-1][1], SHARD_WAIT_S,
                 "the informer's view of the churn")
        fleets = [b.fleet for b in bundles]
        # a fleet controller fed by the informer reconciles its encoding
        # with a fresh list at least every sync_every + 1 scans: after
        # the scan in flight now, at most sync_every - (scans since its
        # last reconcile) trust the feed (read before its count)
        reconciled = {id(c): c.sync_every - c._scans_since_sync
                      + scan_count(c) + 2 for c in fleets}
        seen = after_now(list(ctrls.values()))
        wait_for(lambda: scanned(list(ctrls.values()), seen), SHARD_WAIT_S,
                 "every shard's scans after the churn")
        out["churn_scanned_s"] = time.perf_counter() - t_churn
        # a fleet scan that listed before the churn and reconciled its
        # encoding after the informer fed it the churn writes the older
        # state back, and the scans after it trust the feed until the
        # next reconciling scan (both packages; ROADMAP Queue 3): count
        # the rows each shard's report has wrong now, then hold every
        # report to the truth after a reconciling scan
        out["churn_rows_wrong"] = {
            b.shard_id: rows_wrong(b.fleet.last_report, truth[b.shard_id])
            for b in bundles}
        wait_for(lambda: scanned(fleets, reconciled), SHARD_WAIT_S,
                 "every shard's reconciling fleet scan after the churn")
        out["churn_check"] = check_shard_reports(mgr, kube, truth, members)
        out["churn_s"] = time.perf_counter() - t_churn
        out["churned_nodes"] = len(churn)
        slo["after_churn"] = slo_pass(observer, sources)
        # the sources hold the shards' bound methods, and through them
        # the controllers and their device sessions
        del observer, sources
        out["scan_s"] = {"cold": scan_window(ctrls, {}),
                         "churn": scan_window(ctrls, at_churn)}

        # host-0 dies without releasing its leases; host-1 takes its
        # shards after a lease duration of staleness
        t_kill = time.perf_counter()
        killed = mgr.kill_host(0)
        orphaned = killed["orphaned_shards"]
        require(orphaned == [f"shard-{k}" for k in range(SHARDS)
                             if k % SHARD_HOSTS == 0],
                f"host-0 held {orphaned}")
        require(mgr.wait_failovers(timeout_s=SHARD_WAIT_S),
                "the orphaned shards were not re-acquired")
        out["failover_s"] = time.perf_counter() - t_kill
        (failover,) = mgr.stats()["failovers"]
        # stamped from the end of crash(), which joins the dead host's
        # scan threads first, to the last orphaned shard's re-acquiry
        out["handoff_s"] = failover["handoff_s"]
        require(set(mgr.coverage().values()) == {"host-1"},
                f"coverage after the failover {mgr.coverage()}")
        fresh = [b for b in mgr.bundles() if b.shard_id in orphaned]
        require(sorted(b.shard_id for b in fresh) == orphaned,
                f"host-1 runs {[b.shard_id for b in mgr.bundles()]}")
        sessions += shard_sessions(fresh)
        fresh_ctrls = {f"{label}/failover": c for label, c
                       in shard_controllers(fresh).items()}
        wait_for(lambda: scanned(list(fresh_ctrls.values())), SHARD_WAIT_S,
                 "the re-acquired shards' first scans")
        require(sum(b.fleet.last_report["nodes"] for b in mgr.bundles())
                == FLEET_NODES, "the shards' scans after the failover do "
                                "not cover the fleet")
        out["scan_s"]["failover"] = scan_window(fresh_ctrls, {})
        # each orphaned lease changed hands once; no other lease did
        leases = lease_holders(kube, SHARDS)
        out["leases"] = leases
        out["unplanned_failovers"] = (sum(t for _, t in leases)
                                      - len(orphaned))
        require(leases == [("host-1", int(f"shard-{k}" in orphaned))
                           for k in range(SHARDS)],
                f"shard leases after the failover {leases}")
        out["orphaned"] = orphaned
        out["memory_peak"] = torch.cuda.max_memory_allocated(DEVICE)
        out["killed_at"] = t_kill
        del bundles, fresh, ctrls, fleets, fresh_ctrls
    finally:
        mgr.stop()
    del mgr
    torch.cuda.synchronize()
    out["memory_after_stop"] = torch.cuda.memory_allocated(DEVICE)
    out["threads_after_stop"] = started_since(threads_before)
    wake_watches(kube, nodes[0]["metadata"]["name"], policy=True)
    wait_for(lambda: not started_since(threads_before), 60,
             "the manager's threads to end")
    gc.collect()
    torch.cuda.synchronize()
    out["memory_after"] = torch.cuda.memory_allocated(DEVICE)
    require(out["memory_after"] <= out["memory_before"],
            f"device memory {out['memory_before']} -> {out['memory_after']} "
            "bytes after the manager and its threads stopped")
    return slo


def region_kube(region: str, seed: int) -> Any:
    """One region's API server: ``REGION_NODES`` of phase 3's seeded
    nodes in ``REGION_POOLS`` pools of whole slices, desired ``off``."""
    from tpu_cc_manager_torch import labels as L
    from tpu_cc_manager_torch.k8s.fake import FakeKube

    kube = FakeKube(watch_history_limit=WATCH_HISTORY_PER_NODE * REGION_NODES)
    for i, node in enumerate(make_nodes(REGION_NODES, seed=seed)):
        labels = node["metadata"]["labels"]
        labels[POOL_LABEL] = f"{region}-p{(i // SLICE_HOSTS) % REGION_POOLS}"
        labels[L.CC_MODE_LABEL] = "off"
        kube.add_node(node)
    return kube


def pool_node_names(kube: Any, pools: List[str]) -> List[str]:
    return sorted(n["metadata"]["name"] for n in kube.list_nodes()
                  if n["metadata"]["labels"].get(POOL_LABEL) in pools)


def all_labelled(kube: Any, names: List[str], key: str, value: str) -> bool:
    return all(kube.peek_node_label(n, key) == value for n in names)


def converge_states(kube: Any, names: List[str], mode: str) -> int:
    """The agents' part, for the nodes no agent runs on: each node's
    state label written to ``mode``; returns the writes."""
    from tpu_cc_manager_torch import labels as L

    writes = 0
    for name in names:
        if kube.peek_node_label(name, L.CC_MODE_STATE_LABEL) != mode:
            kube.set_node_labels(name, {L.CC_MODE_STATE_LABEL: mode})
            writes += 1
    return writes


def federation(tmp: str, sessions: List[Dict[str, int]],
               out: Dict[str, Any]) -> None:
    """Phase 11 (c): two regions behind one region-affine ring, the
    agent's node and its 8 pods in region-a; one posture to ``on`` with
    region-b's window 60 s away flips the agent's cards, region-a
    converges, region-b still reads ``off``; region-a's evacuation
    collapses region-b's window and cordons region-a; once the posture
    holds, the federation's judges read no node from either API
    server. Fills ``out``, the ``federation`` finding, as it goes, and
    ``sessions`` with the stats of every region shard's planner
    session."""
    from tpu_cc_manager_torch import labels as L
    from tpu_cc_manager_torch.federation import (
        FederationManager, FleetPosture, RegionSpec)
    from tpu_cc_manager_torch.kernels import LAUNCHES

    kubes = {region: region_kube(region, seed=110 + i)
             for i, region in enumerate(REGIONS)}
    pools = {region: [f"{region}-p{k}" for k in range(REGION_POOLS)]
             for region in REGIONS}
    fed = FederationManager(
        [RegionSpec(region, (lambda k=kubes[region]: k), pools[region])
         for region in REGIONS],
        pool_label=POOL_LABEL, shards_per_region=REGION_SHARDS)
    out.update({"regions": list(REGIONS), "nodes": REGION_NODES,
                "pools": REGION_POOLS, "shards": REGION_SHARDS})
    threads_before = set(threading.enumerate())
    started = False
    try:
        with flip_agent(tmp, kubes["region-a"], pools["region-a"][0]) as (
                kube_a, agent, backend, paths, spans):
            names = {region: pool_node_names(kubes[region], pools[region])
                     for region in REGIONS}
            require(AGENT_NODE in names["region-a"]
                    and OTHER_NODE not in names["region-a"],
                    "the agent's node is not in region-a's pools")
            keep = pods_on(kube_a, OTHER_NODE)
            other_labels = kube_a.get_node(OTHER_NODE)["metadata"]["labels"]
            t0 = time.perf_counter()
            started = True
            fed.start()
            require(fed.wait_covered(timeout_s=SHARD_WAIT_S),
                    f"the regions' coverage {fed.stats()['managers']}")
            bundles = [b for m in fed.managers.values() for b in m.bundles()]
            require(len(bundles) == len(REGIONS) * REGION_SHARDS
                    and all(b.pools for b in bundles),
                    f"the regions' shards {[(b.shard_id, sorted(b.pools)) for b in bundles]}")
            sessions += shard_sessions(bundles)
            wait_for(lambda: scanned([b.fleet for b in bundles]),
                     SHARD_WAIT_S, "every region shard's first fleet scan")
            out["covered_and_scanned_s"] = time.perf_counter() - t0
            out["partition"] = {b.shard_id: sorted(b.pools) for b in bundles}

            # one posture; region-b's window is 60 s away
            spans.clear()
            probes, gen = LAUNCHES["probe_add_one"], backend.runtime_gen
            t0 = time.perf_counter()
            fed.apply_posture(FleetPosture(
                "on", windows={"region-b": REGION_B_WINDOW_S},
                source="chip_smoke"))
            out["desired_write_s"] = wait_for(
                lambda: all_labelled(kube_a, names["region-a"],
                                     L.CC_MODE_LABEL, "on"),
                SHARD_WAIT_S, "region-a's desired write")
            wait_for(lambda: kube_a.peek_node_label(
                AGENT_NODE, L.CC_MODE_STATE_LABEL) == "on", FLIP_TIMEOUT_S,
                "the agent's flip to on")
            out["agent_flip_s"] = time.perf_counter() - t0
            k5 = check_flip(kube_a, agent, paths, "on", keep, other_labels,
                            probes, gen, backend)
            out["probe_launches"] = k5
            out["cards"] = len(paths)
            out["spans_s"] = {k: sum(v) for k, v in spans.items()}
            out["state_writes_a"] = converge_states(
                kube_a, [n for n in names["region-a"] if n != AGENT_NODE],
                "on")
            wait_for(lambda: fed.region_converged("region-a", "on"),
                     SHARD_WAIT_S, "region-a converged to on")
            out["region_a_converged_s"] = time.perf_counter() - t0
            require(all_labelled(kubes["region-b"], names["region-b"],
                                 L.CC_MODE_LABEL, "off")
                    and not fed.region_converged("region-b", "on"),
                    "region-b left off inside its window")
        # the agent is stopped: the zero-read pin below reads the
        # federation's own judges

        # region-a evacuates; region-b absorbs now, 60 s window or not
        t0 = time.perf_counter()
        entry = fed.evacuate("region-a")
        require(entry["region"] == "region-a", f"evacuation {entry}")
        out["absorb_s"] = wait_for(
            lambda: all_labelled(kubes["region-b"], names["region-b"],
                                 L.CC_MODE_LABEL, "on"),
            SHARD_WAIT_S, "region-b's desired write after the evacuation")
        require(out["absorb_s"] < REGION_B_WINDOW_S,
                f"region-b waited {out['absorb_s']} s: its window did not "
                "collapse")
        wait_for(lambda: fed.region_cordoned("region-a"), SHARD_WAIT_S,
                 "region-a cordoned")
        out["state_writes_b"] = converge_states(
            kubes["region-b"], names["region-b"], "on")
        wait_for(lambda: fed.region_converged("region-b", "on"),
                 SHARD_WAIT_S, "region-b converged to on")
        out["region_b_converged_s"] = time.perf_counter() - t0
        require(fed.wait_posture(timeout_s=SHARD_WAIT_S),
                "the posture does not hold")
        stats = fed.stats()
        (evac,) = stats["evacuations"]
        require(stats["evacuated"] == ["region-a"]
                and evac["cordoned"] == len(names["region-a"])
                and evac["cordon_s"] is not None,
                f"the evacuation {evac}")
        out["cordon_s"] = evac["cordon_s"]
        out["cordoned"] = evac["cordoned"]

        # the zero-read pin: the converged judges run from the informers
        reads = {r: kubes[r].node_read_requests for r in REGIONS}
        for _ in range(ZERO_READ_CHECKS):
            require(fed.region_converged("region-b", "on")
                    and fed.region_cordoned("region-a")
                    and fed.region_converged("region-a", "on"),
                    "the converged posture stopped holding")
        moved = {r: kubes[r].node_read_requests - reads[r] for r in REGIONS}
        require(moved == {r: 0 for r in REGIONS},
                f"node reads during the converged checks: {moved}")
        out["node_reads_during_checks"] = moved
        del bundles
    finally:
        if started:
            fed.stop()
    for region, kube in kubes.items():
        wake_watches(kube, names[region][0], policy=False)
    wait_for(lambda: not started_since(threads_before), 60,
             "the federation's threads to end")


def shard_path(phase10: Dict[str, dict]) -> Dict[str, int]:
    """Phase 11 with its launch counts set to 0 just before it and read
    just after it: every K1 and K2 launch of a shard or region thread
    equal to its plain version, K1 from every shard that held a lease
    and from every re-acquired shard after the failover, K2 exactly once
    per row-writing tick of each shard session, K5 once per card per
    flip. ``phase10`` is phase 10's cold policy counts."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_cc_manager_torch import plan
    from tpu_cc_manager_torch.device import base as device_base
    from tpu_cc_manager_torch.k8s.fake import FakeKube
    from tpu_cc_manager_torch.kernels import LAUNCHES, reset_launches

    nodes_before = dev_nodes()
    cwd_before = set(os.listdir(ROOT))
    set_mesh(1)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp, \
            no_providers():
        kube = FakeKube(
            watch_history_limit=WATCH_HISTORY_PER_NODE * FLEET_NODES)
        names = policy_pools(kube, make_nodes(FLEET_NODES, seed=100),
                             SHARD_POOL_FMT)
        # the phase's own copy of the cluster, kept current by its writes
        nodes = kube.list_nodes()
        device_base.set_backend(None)
        reset_launches()
        shard: Dict[str, Any] = {}
        fed: Dict[str, Any] = {}
        sessions: List[Dict[str, int]] = []
        try:
            with held_to_plain() as held:
                with profile(activities=activities) as prof:
                    slo = sharded_plane(kube, nodes, names, phase10,
                                        sessions, shard)
                    torch.cuda.synchronize()
                shard["device"] = kernel_device_time(prof)
                del kube, nodes
                with profile(activities=activities) as prof:
                    federation(tmp, sessions, fed)
                    torch.cuda.synchronize()
                fed["device"] = kernel_device_time(prof)
        except Exception:
            # what the phase had seen when it failed
            finding(phase="shard_path_failed", shard_scan=shard,
                    federation=fed)
            raise
        finally:
            device_base.set_backend(None)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    require_plain(held, "the shard and region threads")
    k1 = launches_of(held, "fleet_tick")
    k2 = launches_of(held, "delta_scatter")
    require(len(k1) == launches["fleet_tick"]
            and len(k2) == launches["delta_scatter"],
            f"{len(k1)} K1 and {len(k2)} K2 launches held of "
            f"{launches['fleet_tick']} and {launches['delta_scatter']}")
    killed_at = shard.pop("killed_at")
    region_shards = [f"{region}/shard-{k}" for region in REGIONS
                     for k in range(REGION_SHARDS)]
    for sid in [f"shard-{k}" for k in range(SHARDS)] + region_shards:
        threads = (f"shard-fleet-{sid}", f"shard-policy-{sid}")
        require(any(r["thread"] in threads for r in k1),
                f"{sid}'s controllers launched no K1")
    for sid in shard["orphaned"]:
        require(any(r["thread"].endswith(sid) and r["t"] >= killed_at
                    for r in k1),
                f"{sid}'s controllers launched no K1 after the failover")
    require(all(r["thread"].startswith("shard-") for r in held),
            f"launches from other threads: "
            f"{sorted({r['thread'] for r in held})}")
    writes = sum(st["delta_puts"] // 2 for st in sessions)
    cards = len(plan._by_device(plan._planner_mesh(DEVICE)))
    require(launches["delta_scatter"] == cards * writes,
            f"{launches['delta_scatter']} delta_scatter launches, not one "
            f"per card per row-writing tick ({cards} x {writes})")
    require(fed["probe_launches"] == fed["cards"]
            and launches["probe_add_one"] == 2 * fed["cards"],
            f"{launches['probe_add_one']} probe_add_one launches, not one "
            f"per card per flip (2 x {fed['cards']})")
    require(shard["unplanned_failovers"] == 0,
            f"{shard['unplanned_failovers']} shard leases changed hands "
            "that no host's death explains")
    require(dev_nodes() == nodes_before, "a /dev/nvidia* node changed")
    require(set(os.listdir(ROOT)) == cwd_before,
            "the shards wrote into the repository root")
    ticks = {k: sum(st[k] for st in sessions)
             for k in ("rebuilds", "incr_ticks", "full_ticks", "cached_ticks")}
    for out, regional in ((shard, False), (fed, True)):
        # a region's shard ids read <region>/shard-<k>
        rows = [r for r in held if ("/" in r["thread"]) == regional]
        out["launches"] = {
            kernel: sum(r["kernel"] == kernel for r in rows)
            for kernel in ("fleet_tick", "delta_scatter")}
        out["shapes"] = sorted({f"{r['kernel']}:{r['shape']}" for r in rows})
    shard["launch_threads"] = {
        t: sorted({r["kernel"] for r in held if r["thread"] == t})
        for t in sorted({r["thread"] for r in held if "/" not in r["thread"]})}
    finding(phase="shard_scan", **shard)
    finding(phase="slo_observe", **slo)
    finding(phase="federation", **fed)
    finding(phase="shard_path", launches=launches, sessions=len(sessions),
            row_writing_ticks=writes, ticks=ticks, flips=2)
    return launches


# ------------------------------------------- phase 12: the scenario lab

#: the bench's four lab runs (``bench.py``'s ``run_simlab_bench``,
#: ``run_shard_bench``, ``run_lifecycle_bench``,
#: ``run_federation_bench``): scenario -> the artifact's metrics that
#: give the bench's numbers, by the bench's name
SIMLAB_SCENARIOS = {
    "scale-256": {"pool256_convergence_s": "pool256_convergence_s"},
    "scale-1024": {"pool1024_convergence_s": "pool1024_convergence_s",
                   "shard_failover_convergence_s":
                       "shard_failover_convergence_s"},
    "upgrade-256": {"lifecycle_convergence_s": "pool256_convergence_s"},
    "federation-2x512": {"region_evac_convergence_s":
                             "region_evac_convergence_s"},
}
#: phase 12 (g)'s episodes
PROPGEN_ARGS = ("--seeds", "1,2", "--families", "shards,policy")
SIMLAB_CLI_TIMEOUT_S = 300


def lab_cells(lab: Any) -> List[Any]:
    """(store, pump, node names) of each API server a lab ran: one for
    ``SimLab``, one per region for ``FederationLab``."""
    if lab.server is not None:
        return [(lab.server.store, lab.pump, lab.node_names)]
    return [(cell.store, cell.pump, cell.node_names)
            for cell in lab.cells.values()]


def lab_threads(before: set) -> List[str]:
    """:func:`started_since`, but for the fake API servers' request
    handlers: a watch stream's handler runs on to its watch's timeout
    after its client has gone, and holds no controller."""
    return [t for t in started_since(before)
            if not t.endswith("(process_request_thread)")]


def lab_readings(cells: List[Any]) -> Tuple[Dict[str, Any], List[float], int]:
    """Every node's ``cc.mode.state`` on a stopped lab's API servers, its
    watch pumps' lag samples and their deliveries. A function of its own,
    so that no loop variable of the caller keeps a pump, and through its
    replicas the lab and its controllers' device sessions, alive."""
    from tpu_cc_manager_torch import labels as L

    states: Dict[str, Any] = {}
    lags: List[float] = []
    delivered = 0
    for store, pump, names in cells:
        for node in names:
            states[node] = store.peek_node_label(node,
                                                 L.CC_MODE_STATE_LABEL)
        with pump._lag_lock:
            lags += pump.lag_samples
        delivered += pump.delivered_total
    return states, lags, delivered


def wake_lab_watches(cells: List[Any], policy: bool) -> None:
    """:func:`wake_watches` for a stopped lab: one node write on each of
    its API servers' stores (the scenario's own write path, past any
    write fault still armed), and a policy object where the lab ran the
    policy plane."""
    from tpu_cc_manager_torch import labels as L

    for store, _pump, names in cells:
        store.set_node_labels_direct(names[0],
                                     {"tpu-cc-smoke/stopped": "true"})
        if policy:
            store.add_custom(L.POLICY_GROUP, L.POLICY_PLURAL, {
                "apiVersion": f"{L.POLICY_GROUP}/{L.POLICY_VERSION}",
                "kind": L.POLICY_KIND,
                "metadata": {"name": "smoke-stopped"},
                "spec": {"mode": "off",
                         "nodeSelector": "tpu-cc-smoke/none"}})


def simlab_scenario(name: str) -> Tuple[dict, List[dict]]:
    """One of the bench's lab runs on the card, as ``bench.py`` runs it:
    the scenario as written, every controller planning on ``cuda:0``,
    every K1 and K2 launch recorded with its difference from its plain
    version (held by the caller), the run under ``torch.profiler``; then
    the invariants oracle, every node's state read from the lab's API
    servers, and device memory back to its level once the lab's threads
    have ended. Returns the ``simlab`` finding and the launch rows."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_cc_manager_torch.simlab.federation import FederationLab
    from tpu_cc_manager_torch.simlab.invariants import check_run
    from tpu_cc_manager_torch.simlab.report import percentile
    from tpu_cc_manager_torch.simlab.runner import SimLab
    from tpu_cc_manager_torch.simlab.scenario import load_scenario

    sc = load_scenario(os.path.join(ROOT, "scenarios", f"{name}.json"))
    # a lab is a cycle of references: the last one's sessions are freed
    # by a collection, not when its last name goes
    gc.collect()
    torch.cuda.synchronize()
    memory_before = torch.cuda.memory_allocated(DEVICE)
    torch.cuda.reset_peak_memory_stats(DEVICE)
    threads_before = set(threading.enumerate())
    lab = FederationLab(sc) if sc.regions else SimLab(sc)
    with held_to_plain() as held, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        art = lab.run()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(DEVICE) - memory_before
    violations = [v.to_dict() for v in check_run(lab, art)]
    cells = lab_cells(lab)
    states, lags, delivered = lab_readings(cells)
    del lab
    wake_lab_watches(cells, policy=sc.controllers.policy)
    del cells
    wait_for(lambda: not lab_threads(threads_before), 60,
             f"{name}: the lab's threads to end")
    gc.collect()
    torch.cuda.synchronize()
    memory_after = torch.cuda.memory_allocated(DEVICE)

    m = art["metrics"]
    device = kernel_device_time(prof)
    kernel_ms = device["kernel_ms"] if isinstance(device, dict) else 0.0
    converged = sum(s == sc.converge.mode for s in states.values())
    out = {
        "scenario": name, "nodes": sc.nodes, "ok": art["ok"],
        "notes": art.get("notes"),
        **{axis: m.get(key) for axis, key in SIMLAB_SCENARIOS[name].items()},
        "initial_convergence_s": m["initial_convergence_s"],
        "converged_nodes": converged,
        "violations": violations,
        "watch_pump": {"lag_p50_s": percentile(lags, 0.50),
                       "lag_p99_s": percentile(lags, 0.99),
                       "lag_samples": len(lags),
                       "delivered": delivered},
        "throttle": {k: m["throttle"].get(k) for k in
                     ("waits", "wait_s_total", "wait_p50_s", "wait_max_s")},
        "faults": [f["fault"] for f in art["faults"] if "fault" in f],
        "host_s": host_s,
        "launches": {k: len(launches_of(held, k))
                     for k in ("fleet_tick", "delta_scatter")},
        "shapes": sorted({f"{r['kernel']}:{r['shape']}" for r in held}),
        "device": device,
        "busy_share": kernel_ms / 1e3 / host_s,
        "memory_before": memory_before, "memory_peak_above": peak,
        "memory_after": memory_after,
    }
    require(art["ok"], f"{name}: the lab did not converge: {art.get('notes')}")
    require(violations == [], f"{name}: invariants violated: {violations}")
    require(all(out[axis] is not None for axis in SIMLAB_SCENARIOS[name]),
            f"{name}: no {list(SIMLAB_SCENARIOS[name])} in the artifact")
    require(memory_after <= memory_before,
            f"{name}: device memory {memory_before} -> {memory_after} bytes "
            "after the lab and its threads stopped")
    return out, held


def simlab_entry_points(tmp: str) -> dict:
    """Phase 12 (e)-(g): ``simlab validate``, ``run`` and ``propgen`` in
    subprocesses against the repository's scenarios, planning on the
    card."""
    from tpu_cc_manager_torch.simlab.scenario import load_scenario

    env = dict(os.environ, **NO_PROVIDERS, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("TPU_CC_TORCH_DEVICE", None)
    scenarios = os.path.join(ROOT, "scenarios")
    before = sorted(os.listdir(scenarios))
    paths = [os.path.join(scenarios, f) for f in before
             if f.endswith(".json")]
    out: Dict[str, Any] = {"scenarios": len(paths)}

    t0 = time.perf_counter()
    p = agent_cli(["simlab", "validate", *paths], env, SIMLAB_CLI_TIMEOUT_S)
    out["validate_s"] = time.perf_counter() - t0
    require(p.returncode == 0,
            f"simlab validate exited {p.returncode}: {p.stderr[-2000:]}")
    want = []
    for path in paths:
        sc = load_scenario(path)
        want.append(f"{path}: ok ({sc.nodes} nodes, "
                    f"{len(sc.actions)} actions)")
    require(p.stdout.splitlines() == want,
            f"simlab validate printed {p.stdout[-2000:]}")

    art_path = os.path.join(tmp, "smoke-64.json")
    t0 = time.perf_counter()
    p = agent_cli(["simlab", "run", os.path.join(scenarios, "smoke-64.json"),
                   "--out", art_path], env, SIMLAB_CLI_TIMEOUT_S)
    out["run_s"] = time.perf_counter() - t0
    require(p.returncode == 0,
            f"simlab run exited {p.returncode}: {p.stderr[-2000:]}")
    with open(art_path) as f:
        art = json.load(f)
    require(art["ok"] is True and art["nodes"] == 64,
            f"simlab run's artifact {str(art)[:2000]}")
    out["run_convergence_s"] = art["metrics"]["pool64_convergence_s"]

    finds, reports = os.path.join(tmp, "finds"), os.path.join(tmp, "reports")
    t0 = time.perf_counter()
    p = agent_cli(["simlab", "propgen", *PROPGEN_ARGS, "--scenario-dir",
                   finds, "--report-dir", reports], env, SIMLAB_CLI_TIMEOUT_S)
    out["propgen_s"] = time.perf_counter() - t0
    require(p.returncode == 0,
            f"simlab propgen exited {p.returncode}: {p.stdout[-2000:]} "
            f"{p.stderr[-2000:]}")
    written = [d for d in (finds, reports)
               if os.path.isdir(d) and os.listdir(d)]
    require(not written, f"simlab propgen wrote a find: {written}")
    require(sorted(os.listdir(scenarios)) == before,
            "simlab propgen wrote into scenarios/")
    # a progress line per episode, then the episodes' summaries
    lines = p.stdout.splitlines()
    episodes = json.loads("\n".join(lines[lines.index("["):]))
    require(len(episodes) == 2 and all(e["ok"] for e in episodes),
            f"simlab propgen's episodes {str(episodes)[:2000]}")
    out["propgen"] = [{k: e.get(k) for k in ("seed", "name", "ok",
                                             "convergence")}
                      for e in episodes]
    return out


def simlab_path() -> Dict[str, int]:
    """Phase 12 with its launch counts set to 0 just before it and read
    just after it: every K1 and K2 launch of the labs' threads equal to
    its plain version; K1 and K2 in (a), K1 from every shard's session
    in (b) and from every region shard in (d), none in (c)."""
    from tpu_cc_manager_torch.device import base as device_base
    from tpu_cc_manager_torch.kernels import LAUNCHES, reset_launches

    nodes_before = dev_nodes()
    cwd_before = set(os.listdir(ROOT))
    set_mesh(1)
    labs: Dict[str, dict] = {}
    held: Dict[str, List[dict]] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp, \
            no_providers():
        device_base.set_backend(None)
        reset_launches()
        try:
            for name in SIMLAB_SCENARIOS:
                labs[name], held[name] = simlab_scenario(name)
                finding(phase="simlab", **labs[name])
            entry = simlab_entry_points(tmp)
        except Exception:
            # what the phase had seen when it failed
            finding(phase="simlab_path_failed", labs=labs)
            raise
        finally:
            device_base.set_backend(None)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    rows = [r for rs in held.values() for r in rs]
    require_plain(rows, "the labs' threads")
    for kernel in ("fleet_tick", "delta_scatter"):
        require(len(launches_of(rows, kernel)) == launches[kernel],
                f"{len(launches_of(rows, kernel))} {kernel} launches held "
                f"of {launches[kernel]}")
    k1 = {name: {r["thread"] for r in launches_of(rs, "fleet_tick")}
          for name, rs in held.items()}
    require(labs["scale-256"]["launches"]["fleet_tick"] > 0
            and labs["scale-256"]["launches"]["delta_scatter"] > 0,
            f"scale-256 launched {labs['scale-256']['launches']}")
    require(labs["scale-256"]["converged_nodes"] == 256,
            f"scale-256: {labs['scale-256']['converged_nodes']} of 256 "
            "nodes read cc.mode.state=on")
    for name in ("scale-1024", "upgrade-256"):
        require(labs[name]["converged_nodes"] == labs[name]["nodes"],
                f"{name}: {labs[name]['converged_nodes']} of "
                f"{labs[name]['nodes']} nodes converged")
    for sid in (f"shard-{k}" for k in range(4)):
        require(f"shard-fleet-{sid}" in k1["scale-1024"],
                f"scale-1024: {sid}'s session launched no K1 "
                f"({sorted(k1['scale-1024'])})")
    require(not held["upgrade-256"],
            "upgrade-256 runs no controller, yet launched "
            f"{labs['upgrade-256']['launches']}")
    for region in ("us-east", "eu-west"):
        require(any(t.startswith(f"shard-fleet-{region}/")
                    for t in k1["federation-2x512"]),
                f"federation-2x512: {region}'s shards launched no K1 "
                f"({sorted(k1['federation-2x512'])})")
    require(dev_nodes() == nodes_before, "a /dev/nvidia* node changed")
    require(set(os.listdir(ROOT)) == cwd_before,
            "the labs wrote into the repository root")
    finding(phase="simlab_entry_points", **entry)
    finding(phase="simlab_path", launches=launches,
            k1_threads={name: sorted(ts) for name, ts in k1.items()})
    return launches


# ------------------------------------------- phase 13: the sysfs backend

SYSFS_MODES = ("on", "off", "devtools")
#: where the sysfs backend looks on a card's host
PCI_ROOT = "/sys/bus/pci/devices"
NVIDIA_PROC_ROOT = "/proc/driver/nvidia/gpus"
DEV_ROOT = "/dev"
#: the H100 SXM's PCI class: a 3D controller
H100_CLASS = "0x030200"
#: the variables phase 13 sets for its flips and CLI calls, and the ones
#: it unsets
SYSFS_ENV = {"TPU_CC_DEVICE_GATING": "none", "TPU_CC_HOLDER_CHECK": "none"}
SYSFS_UNSET = ("TPU_SYSFS_RESET_ATTR", "TPUDEVCTL")


def pci_functions(root: str) -> List[dict]:
    """Every NVIDIA function under ``root``: its bdf, class and device id,
    read straight from sysfs (not through the backend)."""
    out: List[dict] = []
    if not os.path.isdir(root):
        return out
    for bdf in sorted(os.listdir(root)):
        attrs = {}
        for name in ("vendor", "class", "device"):
            try:
                with open(os.path.join(root, bdf, name)) as f:
                    attrs[name] = f.read().strip()
            except OSError:
                attrs[name] = None
        if (attrs["vendor"] or "").lower() == "0x10de":
            out.append({"bdf": bdf, "class": attrs["class"],
                        "device": attrs["device"]})
    return out


def smi_card() -> Dict[str, Optional[str]]:
    """``nvidia-smi``'s bus id, PCI device id and device minor of card 0,
    one query each: None where it refuses the field, and ``[N/A]`` as it
    prints it where it cannot read the value."""
    out: Dict[str, Optional[str]] = {}
    for field in ("pci.bus_id", "pci.device_id", "minor_number"):
        proc = subprocess.run(
            ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        lines = proc.stdout.strip().splitlines()
        out[field] = lines[0].strip() if proc.returncode == 0 and lines \
            else None
    return out


def open_nvidia_minors() -> List[int]:
    """The minors of the ``/dev/nvidia<N>`` nodes this process holds open:
    the card the CUDA runtime opened."""
    minors = set()
    for fd in os.listdir("/proc/self/fd"):
        try:
            target = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            continue
        name = os.path.basename(target)
        if target.startswith("/dev/nvidia") and name[6:].isdigit():
            minors.add(int(name[6:]))
    return sorted(minors)


def card_tree(root: str, bdf: str, device_id: str, minor: int
              ) -> Tuple[str, str]:
    """The one-function PCI tree and driver information file a card's host
    shows for the card, under ``root``, from what the card reports: the
    CUDA runtime's PCI address, ``nvidia-smi``'s device id and the minor
    of the devfs node the runtime holds. Returns the sysfs root and the
    driver's gpus root."""
    sysfs = os.path.join(root, "sys_bus_pci_devices")
    proc = os.path.join(root, "proc_driver_nvidia_gpus")
    fn, info = os.path.join(sysfs, bdf), os.path.join(proc, bdf)
    os.makedirs(fn)
    os.makedirs(info)
    for name, value in (("vendor", "0x10de"), ("device", device_id),
                        ("class", H100_CLASS)):
        with open(os.path.join(fn, name), "w") as f:
            f.write(value + "\n")
    with open(os.path.join(info, "information"), "w") as f:
        f.write(f"Model: \t\t {torch.cuda.get_device_name(0)}\n"
                f"Bus Location: \t {bdf}\nDevice Minor: \t {minor}\n")
    return sysfs, proc


@contextlib.contextmanager
def sysfs_env(extra: Dict[str, str]):
    """``SYSFS_ENV`` and ``extra`` in this process's environment and
    ``SYSFS_UNSET`` out of it, restored after."""
    keys = set(SYSFS_ENV) | set(extra) | set(SYSFS_UNSET)
    keep = {k: os.environ.get(k) for k in keys}
    for k in SYSFS_UNSET:
        os.environ.pop(k, None)
    os.environ.update(SYSFS_ENV)
    os.environ.update(extra)
    try:
        yield
    finally:
        for k, v in keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def reset_writes():
    """Record every file a ``SysfsGpuChip.reset`` opens for writing (on
    any thread); yields ``(writes, resets)``, the paths and the count of
    resets."""
    import builtins

    from tpu_cc_manager_torch.device.gpu import SysfsGpuChip

    writes: List[str] = []
    resets = [0]
    in_reset = threading.local()
    real_open, real_reset = builtins.open, SysfsGpuChip.reset

    def recording_open(file, mode="r", *a, **kw):
        if getattr(in_reset, "on", False) and any(c in mode for c in "wax+"):
            writes.append(os.path.abspath(str(file)))
        return real_open(file, mode, *a, **kw)

    def reset(self):
        in_reset.on = True
        resets[0] += 1
        try:
            return real_reset(self)
        finally:
            in_reset.on = False

    builtins.open, SysfsGpuChip.reset = recording_open, reset
    try:
        yield writes, resets
    finally:
        builtins.open, SysfsGpuChip.reset = real_open, real_reset


def build_tpudevctl(tmp: str) -> Optional[str]:
    """``native/``'s ``tpudevctl`` built with ``make`` into ``tmp``, or None
    when the host has no ``make`` or ``g++``."""
    import shutil

    if not (shutil.which("make") and shutil.which("g++")):
        return None
    build = os.path.join(tmp, "native-build")
    target = os.path.join(build, "tpudevctl")
    proc = subprocess.run(["make", "-C", os.path.join(ROOT, "native"),
                           f"BUILD={build}", target],
                          capture_output=True, text=True, timeout=300)
    require(proc.returncode == 0, f"make tpudevctl: {proc.stderr[-2000:]}")
    return target


def sysfs_phase(tmp: str, smi: str) -> Tuple[dict, Dict[str, int]]:
    """Phase 13: the sysfs backend on the card's host. Returns the phase's
    readings and the launch counts of its path (K5 from the probe after
    the flip cycle)."""
    from tpu_cc_manager_torch.device.cudadev import CudaBackend
    from tpu_cc_manager_torch.device.gate import DeviceGate
    from tpu_cc_manager_torch.device.gpu import SysfsGpuBackend
    from tpu_cc_manager_torch.device.holders import HolderCheck, find_holders
    from tpu_cc_manager_torch.engine import ModeEngine
    from tpu_cc_manager_torch.kernels import LAUNCHES, reset_launches
    from tpu_cc_manager_torch.kernels.probe import (
        probe_add_one, probe_add_one_reference)
    from tpu_cc_manager_torch.trace import Tracer

    t_phase = time.perf_counter()
    nodes_before = dev_nodes()
    state = os.path.join(tmp, "sysfs-state")

    # (a) enumeration, read only: the host's own PCI tree first
    t0 = time.perf_counter()
    functions = pci_functions(PCI_ROOT)
    host = SysfsGpuBackend(sysfs_root=PCI_ROOT, dev_root=DEV_ROOT,
                           nvidia_proc_root=NVIDIA_PROC_ROOT,
                           state_dir=state)
    host_gpus, err = host.find_tpus()
    host_switches = host.find_ici_switches()
    enumerate_s = time.perf_counter() - t0
    require(err is None, f"sysfs enumeration failed: {err}")
    cuda = CudaBackend(state_dir=os.path.join(tmp, "cuda-state"))
    cuda_chips, cerr = cuda.find_tpus()
    require(cerr is None and cuda_chips, f"CUDA enumeration: {cerr}")
    cuda_bdfs = {c.device_id: c.path[len("cuda:"):] for c in cuda_chips}
    card = smi_card()
    minors = open_nvidia_minors()
    finding(phase="sysfs_host", pci_root=PCI_ROOT,
            pci_root_exists=os.path.isdir(PCI_ROOT),
            nvidia_proc_root_exists=os.path.isdir(NVIDIA_PROC_ROOT),
            nvidia_functions=functions,
            gpus=[{"bdf": c.bdf, "path": c.path, "name": c.name,
                   "device_id": c.device_id,
                   "cc_capable": c.is_cc_query_supported}
                  for c in host_gpus],
            nvswitches=[{"bdf": s.bdf, "path": s.path, "device_id": s.device_id}
                        for s in host_switches],
            cuda_bdfs=cuda_bdfs, nvidia_smi_card=card,
            open_nvidia_minors=minors, enumerate_s=enumerate_s)
    require(len(functions) >= len(host_gpus) + len(host_switches),
            "the backend found functions the raw scan did not")
    if host_gpus:
        source, backend = "host", host
        sysfs_root, proc_root = PCI_ROOT, NVIDIA_PROC_ROOT
    else:
        # No PCI tree in this machine's sysfs: the flip cycle runs over
        # the tree a card's host shows, built from what the card reports,
        # against the real devfs node. The smi minor, where it reads
        # one, must be the node the CUDA runtime holds open.
        source = "card"
        smi_minor = card["minor_number"] or ""
        require(len(minors) == 1 or smi_minor.isdigit(),
                f"cannot tell the card's minor: open {minors}, "
                f"nvidia-smi {smi_minor!r}")
        minor = int(smi_minor) if smi_minor.isdigit() else minors[0]
        require(not minors or minor in minors,
                f"nvidia-smi minor {minor} is not a node this process "
                f"holds open ({minors})")
        raw_id = (card["pci.device_id"] or "").lower()
        if raw_id.startswith("0x") and len(raw_id) == 10:
            # 0x<device><vendor>
            require(raw_id[6:] == "10de", f"vendor of {raw_id!r}")
            device_id = raw_id[:6]
        else:
            # no PCI id from nvidia-smi here: a device id no name maps
            # to, so the chip reads as a plain "gpu"
            device_id = "0xffff"
        sysfs_root, proc_root = card_tree(
            os.path.join(tmp, "card-tree"), cuda_bdfs[0], device_id, minor)
        backend = SysfsGpuBackend(sysfs_root=sysfs_root, dev_root=DEV_ROOT,
                                  nvidia_proc_root=proc_root,
                                  state_dir=state)
    gpus, err = backend.find_tpus()
    require(err is None and gpus, f"sysfs enumeration ({source}): {err}")
    bdfs = {c.bdf: c for c in gpus}
    require(cuda_bdfs[0] in bdfs,
            f"cuda:0 at {cuda_bdfs[0]} is not a sysfs GPU ({sorted(bdfs)})")
    chip0 = bdfs[cuda_bdfs[0]]
    require(chip0.path.startswith(os.path.join(DEV_ROOT, "nvidia"))
            and os.path.exists(chip0.path),
            f"cuda:0's sysfs path {chip0.path!r} is no devfs node")
    if "CUDA_VISIBLE_DEVICES" not in os.environ:
        require(set(cuda_bdfs.values()) == set(bdfs),
                f"CUDA sees {sorted(cuda_bdfs.values())}, sysfs {sorted(bdfs)}")
    paths = [c.path for c in gpus]
    finding(phase="sysfs_enumeration", source=source,
            gpus=[{"bdf": c.bdf, "path": c.path, "name": c.name,
                   "device_id": c.device_id,
                   "cc_capable": c.is_cc_query_supported} for c in gpus],
            nvswitches=len(backend.find_ici_switches()),
            cuda0_bdf=cuda_bdfs[0], cuda0_path=chip0.path)

    # (b) a read-only holder scan of the card's node
    holders = find_holders(chip0.path)
    finding(phase="sysfs_holders", path=chip0.path, count=len(holders),
            commands=sorted({h.comm for h in holders}))

    # (c) the flip cycle through the sysfs backend
    t0 = time.perf_counter()
    ctl = build_tpudevctl(tmp)
    build_ctl_s = time.perf_counter() - t0
    durations: Dict[str, List[float]] = {}
    tracer = Tracer()
    tracer.add_sink(lambda s: durations.setdefault(s.name, []).append(s.dur_s))
    labels: List[str] = []
    flips = []
    # what the CLI subprocesses inherit too
    extra = {"TPU_CC_DEVICE_BACKEND": "sysfs", "TPU_SYSFS_ROOT": sysfs_root,
             "TPU_DEV_ROOT": DEV_ROOT, "TPU_NVIDIA_PROC_ROOT": proc_root,
             **({"TPUDEVCTL": ctl} if ctl else {})}
    with sysfs_env(extra), no_providers(), \
            reset_writes() as (writes, resets):
        # the card's real devfs node: never gated here
        engine = ModeEngine(set_state_label=labels.append, backend=backend,
                            evict_components=False, tracer=tracer,
                            gate=DeviceGate(enabled=False),
                            holder_check=HolderCheck(enabled=False))
        for mode in SYSFS_MODES:
            durations.clear()
            t0 = time.perf_counter()
            ok = engine.set_mode(mode)
            flip_s = time.perf_counter() - t0
            require(ok, f"sysfs set_mode({mode!r}) failed")
            want = {p: {"cc": mode, "ici": "off"} for p in paths}
            modes = engine.get_modes()
            require({p: modes.get(p) for p in paths} == want,
                    f"get_modes after {mode}: {modes}")
            t0 = time.perf_counter()
            got = port_cli(["get-cc-mode"], state)
            inv = port_cli(["probe-devices", "--backend", "sysfs"], state)
            cli_s = time.perf_counter() - t0
            require({p: got.get(p) for p in paths} == want,
                    f"get-cc-mode after {mode}: {got}")
            listed = {d["path"]: d for d in inv["devices"]}
            require(inv["error"] is None and all(
                listed[p]["cc_mode"] == mode and listed[p]["ici_mode"] == "off"
                for p in paths), f"probe-devices after {mode}: {inv}")
            t0 = time.perf_counter()
            for c in backend.find_tpus()[0]:
                require(c.verify_independent("cc") == mode
                        and c.verify_independent("ici") == "off",
                        f"verify_independent of {c.path} after {mode}")
            verify_s = time.perf_counter() - t0
            flip = {"mode": mode, "flip_s": flip_s, "cli_s": cli_s,
                    "verify_independent_s": verify_s,
                    "verify_route": "tpudevctl" if ctl else "in-process",
                    **{f"{ph}_s": sum(durations.get(ph, []))
                       for ph in FLIP_PHASES}}
            finding(phase="sysfs_flip", **flip)
            flips.append(flip)
        t0 = time.perf_counter()
        report = port_cli(["doctor", "--offline"], state)
        doctor_s = time.perf_counter() - t0
    require(labels == list(SYSFS_MODES), f"state labels {labels}")
    require(resets[0] >= len(paths) * len(SYSFS_MODES),
            f"{resets[0]} resets for {len(paths)} GPUs and "
            f"{len(SYSFS_MODES)} flips")
    sysfs_writes = [w for w in writes
                    if w.startswith("/sys") or w.startswith(sysfs_root)]
    require(not sysfs_writes, f"a reset wrote under sysfs: {sysfs_writes}")
    finding(phase="sysfs_doctor", ok=report.get("ok"),
            checks=report.get("checks"), seconds=doctor_s)
    require(report.get("ok") is True, f"doctor --offline: {report}")
    require(any(chip0.path in c.get("detail", "") for c in report["checks"]),
            f"doctor ran no check on {chip0.path}")
    nodes_after = dev_nodes()
    require(nodes_after == nodes_before,
            f"/dev/nvidia* changed: {nodes_before} -> {nodes_after}")

    # (d) the card still answers: K5 through CudaBackend's probe, and the
    # same kernel held bit-equal to its plain version
    reset_launches()
    probe_s = cuda.probe_device(0)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    require(launches["probe_add_one"] == 1,
            f"{launches['probe_add_one']} probe_add_one launches for one probe")
    one = torch.tensor(1.0, dtype=torch.float32, device=DEVICE)
    got, want = probe_add_one(one), probe_add_one_reference(one)
    torch.cuda.synchronize()
    require(float(got) == 2.0 and float_err(got, want) == 0.0,
            f"probe_add_one after the cycle: {float(got)}")
    out = {"source": source, "gpus": len(gpus), "paths": paths,
           "cuda0_bdf": cuda_bdfs[0], "holders": len(holders),
           "enumerate_s": enumerate_s, "build_tpudevctl_s": build_ctl_s,
           "flips": flips, "doctor_s": doctor_s, "probe_s": probe_s,
           "reset_writes": len(writes), "sysfs_writes": 0,
           "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    finding(phase="sysfs", **out)
    return out, launches



# ------------------------------------------ phase 14: the port's analyzer


#: phase 14's scan: each subprocess's time limit
ANALYSIS_TIMEOUT_S = 300
#: what the scan reads besides the package: the manifests and scenarios
#: its cross-check holds to the protocol, and the SLO document
ANALYSIS_TREES = ("tpu_cc_manager_torch", "deployments", "scenarios")


def unlock_eval_fn(source: str) -> str:
    """``plan.py`` with the ``with _DISPATCH_LOCK:`` of ``_eval_fn``'s
    ``run`` turned into ``if True:`` (every line stays where it was)."""
    import ast

    tree = ast.parse(source)
    lines = [
        w.lineno for f in ast.walk(tree)
        if isinstance(f, ast.FunctionDef) and f.name == "_eval_fn"
        for w in ast.walk(f) if isinstance(w, ast.With)
        and ast.unparse(w.items[0].context_expr) == "_DISPATCH_LOCK"]
    require(len(lines) == 1, f"_eval_fn holds _DISPATCH_LOCK at {lines}")
    text = source.splitlines(keepends=True)
    text[lines[0] - 1] = text[lines[0] - 1].replace(
        "with _DISPATCH_LOCK:", "if True:")
    return "".join(text)


def ccaudit(root: str, *args: str) -> Tuple[float, int, str]:
    """``python -m tpu_cc_manager_torch.analysis --root <root> <args>``
    from the repository root: wall seconds, exit code, stdout."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_cc_manager_torch.analysis", "--root",
         root, *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=ANALYSIS_TIMEOUT_S)
    wall = time.monotonic() - t0
    require(proc.returncode in (0, 1),
            f"ccaudit {' '.join(args)} exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    return wall, proc.returncode, proc.stdout


def analysis_phase(smi: str, launched: Dict[str, int]) -> dict:
    """Phase 14: the port's analyzer on the card's machine, over a copy of
    the checkout's package, manifests and scenarios (its fact cache lives
    in the copy): the default-surface scan exits 0 with no new finding
    and no stale baseline entry, cold and then warm through ``--cache``;
    with ``_eval_fn``'s lock removed from the copy's ``plan.py`` it fires
    ``unserialized-dispatch`` at error level; the kernel-launch pass's
    inventory covers every kernel ``launched`` counts, and every launch
    site it found outside ``kernels/`` holds the lock or a pragma."""
    import shutil

    from tpu_cc_manager_torch.analysis import core, launchflow
    from tpu_cc_manager_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        for name in ANALYSIS_TREES:
            shutil.copytree(os.path.join(ROOT, name), os.path.join(tmp, name),
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
        wall = {}
        for label in ("cold", "warm"):
            wall[label], rc, out = ccaudit(tmp, "--cache", "--json")
            doc = json.loads(out)
            require(rc == 0 and not doc["new"] and not doc["stale"],
                    f"ccaudit ({label}) exited {rc}: {len(doc['new'])} new, "
                    f"{len(doc['stale'])} stale: {doc['new'][:3]}")
        modules = len(core.iter_python_files(tmp, core.DEFAULT_TARGETS))
        t0 = time.monotonic()
        inventory, sites = launchflow.survey_paths(tmp, cache=True)
        survey_s = time.monotonic() - t0

        plan = os.path.join(tmp, "tpu_cc_manager_torch", "plan.py")
        with open(plan) as f:
            unlocked = unlock_eval_fn(f.read())
        with open(plan, "w") as f:
            f.write(unlocked)
        sarif = os.path.join(tmp, "armed.sarif")
        wall["armed"], rc, _ = ccaudit(tmp, "--cache", "--no-manifests",
                                       "--sarif", sarif)
        with open(sarif) as f:
            results = json.load(f)["runs"][0]["results"]
    armed = sorted(
        r["locations"][0]["physicalLocation"]["region"]["startLine"]
        for r in results if r["ruleId"] == "unserialized-dispatch"
        and r["level"] == "error")
    require(rc == 1 and armed,
            f"the unlocked plan.py gave rc {rc} and no error-level "
            f"unserialized-dispatch: {results[:3]}")

    covered = {k for x in inventory for k in x.kernels}
    ran = sorted(k for k, n in launched.items() if n > 0)
    require(set(ran) <= covered,
            f"kernels launched outside the pass's inventory: "
            f"{sorted(set(ran) - covered)}")
    outside = [s for s in sites if s.rule == "unserialized-dispatch"]
    require(outside and all(s.status in ("locked", "pragma")
                            for s in outside),
            f"launch sites neither locked nor pragma'd: {outside}")
    require(not [s for s in sites if s.status == "finding"],
            f"the kernel-launch pass found {sites}")
    pragmas: Dict[str, int] = {}
    for s in sites:
        if s.status == "pragma":
            pragmas[s.rule] = pragmas.get(s.rule, 0) + 1
    torch.cuda.synchronize()
    require(not any(LAUNCHES.values()),
            f"phase 14 launched kernels: {dict(LAUNCHES)}")
    out = {
        "cold_s": wall["cold"], "warm_s": wall["warm"],
        "armed_s": wall["armed"], "survey_s": survey_s,
        "modules": modules, "exit": 0, "new": 0, "stale": 0,
        "armed_lines": armed, "pragma_sites": pragmas,
        "dispatch_sites": {status: sum(1 for s in outside
                                       if s.status == status)
                           for status in ("locked", "pragma")},
        "inventory": {x.name: list(x.kernels) for x in inventory},
        "launched": ran, "nvidia_smi": smi,
    }
    finding(phase="analysis", **out)
    return out


# ---------------------------------------------------------------- main


#: the kernels of phases 3-5; probe_add_one's path is phase 7, the
#: mesh kernels' phase 8
PLANNER_KERNELS = ("fleet_tick", "delta_scatter", "fleet_plan")
MESH_KERNELS = ("fleet_tick_partial", "mesh_combine", "delta_scatter",
                "fleet_plan")
KERNELS = {
    "fleet_tick": ("tpu_cc_manager_torch/csrc/fleet_tick.cu",
                   "tpu_cc_manager/plan.py:790"),
    "delta_scatter": ("tpu_cc_manager_torch/csrc/delta_scatter.cu",
                      "tpu_cc_manager/plan.py:1075"),
    "fleet_plan": ("tpu_cc_manager_torch/csrc/fleet_plan.cu",
                   "tpu_cc_manager/plan.py:689"),
    "probe_add_one": ("tpu_cc_manager_torch/csrc/probe.cu",
                      "tpu_cc_manager/device/jaxdev.py:260"),
    "fleet_tick_partial": ("tpu_cc_manager_torch/csrc/fleet_tick.cu",
                           "tpu_cc_manager/plan.py:790"),
    "mesh_combine": ("tpu_cc_manager_torch/csrc/mesh_combine.cu",
                     "tpu_cc_manager/plan.py:864"),
    "rsa_verify": ("tpu_cc_manager_torch/csrc/rsa_verify.cu",
                   "tpu_cc_manager/identity.py:385 (host pow)"),
}


def setup() -> Tuple[str, Any, float, float]:
    """Phase 1: the card's name and power limit, the build, the card's
    memory rate and the launch floor. Returns (nvidia-smi line, library,
    bytes per second, floor ms)."""
    from tpu_cc_manager_torch.kernels import _build

    smi = nvidia_smi()
    finding(phase="setup", torch=torch.__version__, cuda=torch.version.cuda,
            device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    t0 = time.perf_counter()
    lib = _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for line in str(_build.BUILD_STATS["log"]).splitlines()
             if "registers" in line or "spill" in line or "Compiling" in line]
    finding(phase="build", seconds=build_s, hits=_build.BUILD_STATS["hits"],
            misses=_build.BUILD_STATS["misses"], ptxas=ptxas)
    rate = lib.tcc_memory_bytes_per_s(DEVICE.index or 0)
    require(rate > 0, "could not read the card's memory rate")
    finding(phase="memory_rate", bytes_per_s=rate)
    stream = torch.cuda.current_stream(DEVICE).cuda_stream

    def empty() -> None:
        _build.check(lib.tcc_empty_kernel(stream), "empty kernel launch")

    floor = device_ms(empty)
    finding(phase="launch_floor", ms=floor,
            what="one empty kernel through the ctypes route, device_ms")
    return smi, lib, rate, floor


def k1_phase(rate: float) -> Dict[str, List[dict]]:
    """Phase 2's K1 work: K1 and K1's partial form (with K4 over the
    partials) against their plain versions, and the per-launch split of
    K1 and its partial form on its own line."""
    measured = {"fleet_tick": check_k1(rate)}
    measured["fleet_tick_partial"], measured["mesh_combine"] = (
        check_mesh_kernels(rate))
    split = {r["shape"]: r["split"] or "not measured"
             for r in measured["fleet_tick"] + measured["fleet_tick_partial"]
             if "split" in r}
    finding(phase="k1_split", cases=split)
    return measured


def run() -> None:
    from tpu_cc_manager_torch.kernels import LAUNCHES, reset_launches

    # phases 1-7 on one shard, whatever the host has; phase 8 sets its own
    set_mesh(1)
    smi, _lib, rate, floor = setup()
    measured = k1_phase(rate)
    measured["fleet_plan"] = check_k3(rate)
    measured["delta_scatter"] = check_k2(rate)

    reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        fleet = fleet_phase(tmp)
    session, enc, sess = session_phase()
    shapes = entry_phase()
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    finding(phase="main_path", launches=launches, fleet=fleet,
            session=session, entry_shapes=shapes)
    for name in PLANNER_KERNELS:
        require(launches[name] > 0, f"the main path never launched {name}")
    # one K2 launch per incremental tick on one shard, one K3 per entry()
    require(launches["delta_scatter"] == INCR_TICKS,
            f"{launches['delta_scatter']} delta_scatter launches on the main "
            f"path, not one per incremental tick ({INCR_TICKS})")
    require(launches["fleet_plan"] == 1,
            f"{launches['fleet_plan']} fleet_plan launches for one entry()")

    split_full_tick(synthetic_encoding(FLEET_NODES), "100k")
    split_full_tick(enc, "1m")

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        measured["probe_add_one"] = check_k5(rate, tmp)
        reset_launches()
        flip = flip_phase(tmp, sess, enc)
        torch.cuda.synchronize()
        flip_launches = dict(LAUNCHES)
    finding(phase="flip_path", launches=flip_launches, **flip)
    require(flip_launches["probe_add_one"] > 0,
            "the flip path never launched probe_add_one")
    launches["probe_add_one"] = flip_launches["probe_add_one"]

    k2_shards, k3_shards = check_shard_kernels(rate)
    measured["delta_scatter"] += k2_shards
    measured["fleet_plan"] += k3_shards
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        mesh, mesh_launches = mesh_phase(rate, tmp)
    finding(phase="mesh_path", launches=mesh_launches)
    for name in MESH_KERNELS:
        require(mesh_launches[name] > 0,
                f"the mesh path never launched {name}")
    launches["fleet_tick_partial"] = mesh_launches["fleet_tick_partial"]
    launches["mesh_combine"] = mesh_launches["mesh_combine"]

    agent_launches = agent_path()
    controller_launches, phase10 = controller_path()
    shard_launches = shard_path(phase10)
    simlab_launches = simlab_path()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        _sysfs, sysfs_launches = sysfs_phase(tmp, smi)
    measured["rsa_verify"] = [check_k6()]
    rs256 = rs256_path()
    rs256_launches = rs256["launches"]
    launches["rsa_verify"] = rs256_launches["rsa_verify"]
    launched = {
        name: sum(path.get(name, 0) for path in (
            launches, flip_launches, mesh_launches, agent_launches,
            controller_launches, shard_launches, simlab_launches,
            sysfs_launches, rs256_launches))
        for name in KERNELS}
    analysis_phase(smi, launched)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        # the largest shape the main path gives each kernel
        main = max(measured[name],
                   key=lambda r: r.get("rows", r.get("kb", 0)))
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "agent_path_launches": agent_launches[name],
            "controller_path_launches": controller_launches[name],
            "shard_path_launches": shard_launches[name],
            "simlab_path_launches": simlab_launches[name],
            "sysfs_path_launches": sysfs_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in measured[name]),
            "max_abs_diff": max(r["max_abs_err"] for r in measured[name]),
            "shape": main["shape"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main.get("library_ms"),
            "launch_floor_ms": floor,
            "shapes": measured[name],
        })
        if name == "rsa_verify":
            # its own path's counts (phase 15): every RS256 check of the
            # group plan answered from its one launch
            rows[-1].update(rsa_batched=rs256["rsa_batched"],
                            rsa_host=rs256["rsa_host"])
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)


def run_k1() -> None:
    """``--k1``: phases 1 and 2's K1 work alone (K1, K3, K1's partial form
    and K4), for comparing two versions of K1 inside one chip call."""
    set_mesh(1)
    smi, _lib, rate, _floor = setup()
    k1_phase(rate)
    print(smi, flush=True)


def run_k2k3() -> None:
    """``--k2k3``: phase 1 and the K2 and K3 checks of phases 2 and 8 (a)
    alone, with the crossover of K3's two routes, for comparing two
    versions of K2 and K3 inside one chip call."""
    set_mesh(1)
    smi, _lib, rate, _floor = setup()
    check_k2(rate)
    check_k3(rate)
    from tpu_cc_manager_torch.kernels import fleet_tick as KF

    if hasattr(KF, "_plan_route"):
        k3_crossover()
    check_shard_kernels(rate)
    print(smi, flush=True)


#: K6's batch: a group plan's identity and attestation signatures on the
#: cvm5k fleet (~4 790 and ~4 750 a preflight)
K6_BATCH = 9_552


def k6_products(e: int = 65537, limbs: int = 64) -> int:
    """32 x 32 -> 64-bit products K6's function needs for one signature
    under exponent ``e`` with ``limbs``-limb numbers, counting what the
    work needs rather than what K6 does: each Montgomery product's
    reduction n^2 + n (the quotient digit of each of n rounds, then n
    products by the modulus); a general product's a x b half n^2 (into
    the domain by R^2, and each multiply of the ladder), a squaring's
    n(n + 1) / 2 (each cross product once), and the product by 1 that
    leaves the domain n."""
    n = limbs
    reduce = n * n + n
    general = n * n + reduce
    square = n * (n + 1) // 2 + reduce
    squarings = e.bit_length() - 1
    multiplies = bin(e).count("1") - 1
    return (general + squarings * square + multiplies * general
            + n + reduce)


#: 32-bit multiply-adds K6's function needs a signature under e = 65537:
#: each product two (its low and its high half)
K6_IMADS_PER_SIG = 2 * k6_products()
#: 32-bit integer multiply-adds a clock on one SM of compute capability
#: 9.0 (the CUDA C++ Programming Guide's arithmetic throughput table)
IMADS_PER_CLOCK_SM = 64


def check_k6() -> Dict[str, Any]:
    """Phase 15's kernel check: K6 over ``K6_BATCH`` signatures under
    four 2048-bit keys of 8 primes (e 65537, as the cvm5k fleet's): even
    items valid, odd ones with their last byte changed. Bit-equal to the
    plain version, then timed; the bound counts ``K6_IMADS_PER_SIG`` at
    the card's top SM clock."""
    from portbench import attestgen as A
    from tpu_cc_manager_torch.kernels import LAUNCHES
    from tpu_cc_manager_torch.kernels import rsa_verify as K6

    keys = [A.make_key(f"smoke-k6-{i}", f"k{i}", 2048, 8) for i in range(4)]
    valid = [(j % 4, b"smoke.k6.%d" % j) for j in range(800)]
    valid = [(i, msg, A.sign(keys[i], msg)) for i, msg in valid]
    sigs, digests, idx = [], [], []
    for j in range(K6_BATCH):
        i, msg, sig = valid[(j // 2) % len(valid)]
        if j % 2:
            changed = sig[:-1] + bytes([sig[-1] ^ 0x02])
            if int.from_bytes(changed, "big") < keys[i].n:
                sig = changed
        sigs.append(sig)
        digests.append(hashlib.sha256(msg).digest())
        idx.append(i)
    host = [torch.from_numpy(K6.limbs(sigs, K6.LIMBS)),
            torch.tensor(idx, dtype=torch.int32),
            torch.from_numpy(K6.limbs(digests, K6.DIGEST_LIMBS))]
    table = [(k.n, k.e) for k in keys]
    t0 = time.perf_counter()
    want = K6.rsa_verify(*host, *K6.key_table(table, "cpu"))
    plain_ms = 1e3 * (time.perf_counter() - t0)
    args = [t.to(DEVICE) for t in host] + list(K6.key_table(table, DEVICE))
    before = LAUNCHES["rsa_verify"]
    got = K6.rsa_verify(*args)
    torch.cuda.synchronize()
    require(LAUNCHES["rsa_verify"] == before + 1, "K6 did not count one launch")
    differ = int((got.cpu() != want).sum())
    require(differ == 0, f"K6 differs from its plain version on {differ} "
                         f"of {K6_BATCH} signatures")
    ms = device_ms(lambda: K6.rsa_verify(*args))
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.split()
    mhz = float(clock[0]) if clock else 1980.0
    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    bound_ms = 1e3 * K6_BATCH * K6_IMADS_PER_SIG / (
        IMADS_PER_CLOCK_SM * sms * mhz * 1e6)
    out = {"shape": f"B {K6_BATCH}, 4 keys", "verified": int(want.sum()),
           "max_abs_err": differ, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "32-bit multiply-adds",
           "sm_clock_mhz": mhz, "sms": sms,
           "share_of_bound": bound_ms / ms}
    finding(phase="k6", **out)
    return out


#: the cvm5k fleet cut to this many nodes for K6's path (phase 15)
RS256_NODES = 1_000


@contextlib.contextmanager
def environment(values: Dict[str, str]):
    """``os.environ`` with ``values`` set, restored as it was after."""
    saved = dict(os.environ)
    os.environ.update(values)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def rs256_path() -> Dict[str, Any]:
    """Phase 15's path: the cvm5k fleet cut to ``RS256_NODES`` nodes,
    minted by the benchmark's generator with both tokens under the
    configuration's keys and its planted shares, both JWKS files
    provisioned. ``Rollout(kube, "on", dry_run=True).run()`` from launch
    counts set to 0 must launch K6 exactly once, answer every RS256
    check from the batch (``rsa_host`` 0) and plan the groups and
    verdict counts of the same run with no batch. Returns the
    ``rs256_path`` line's readings, the run's launches among them."""
    from portbench import attestgen as A
    from portbench import fleetgen as G
    from portbench.program_spans import ring_records
    from tpu_cc_manager_torch import rs256
    from tpu_cc_manager_torch.k8s.fake import FakeKube
    from tpu_cc_manager_torch.kernels import LAUNCHES, reset_launches
    from tpu_cc_manager_torch.rollout import Rollout

    with open(os.path.join(ROOT, "portbench", "configs", "cvm5k.json")) as f:
        cfg = json.load(f)
    cfg.update(nodes=RS256_NODES, pool_nodes=RS256_NODES // 10)
    seed = 2 ** 33 + 19
    now = time.time()
    nodes = G.make_fleet(cfg, seed, now)
    keys = A.make_keys(seed, cfg)
    key = G.evidence_key(seed)
    A.attest_fleet(nodes, cfg, seed, key, now, keys, workers=1)

    def group_plan() -> Tuple[List[dict], Dict[str, Any], float]:
        kube = FakeKube()
        for node in nodes:
            kube.add_node(copy.deepcopy(node))
        t0 = time.perf_counter()
        groups = Rollout(kube, "on", dry_run=True).run().to_dict()["groups"]
        seconds = time.perf_counter() - t0
        recs, _ = ring_records()
        return groups, [r[6] for r in recs if r[0] == "groups"][-1], seconds

    def verdicts(attrs: Dict[str, Any]) -> Dict[str, int]:
        return {k: v for k, v in attrs.items()
                if k.startswith(("id_", "att_")) and v}

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp, \
            environment({**cfg["env"], **A.write_jwks(tmp, keys),
                         "TPU_CC_EVIDENCE_KEY": key.decode()}):
        reset_launches()
        groups, attrs, seconds = group_plan()
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        prepare = rs256.prepare
        rs256.prepare = lambda annotations: (None, {})
        try:
            plain_groups, plain_attrs, plain_seconds = group_plan()
        finally:
            rs256.prepare = prepare
    out = {"nodes": RS256_NODES, "launches": launches,
           "rsa_batched": attrs["rsa_batched"], "rsa_host": attrs["rsa_host"],
           "rsa_batch_s": attrs["rsa_batch_s"],
           "jwks_loads": attrs["jwks_loads"],
           "jwks_snapshot": attrs["jwks_snapshot"],
           "verdicts": verdicts(attrs),
           "run_s": seconds, "no_batch_run_s": plain_seconds}
    finding(phase="rs256_path", **out)
    require(launches["rsa_verify"] == 1,
            f"{launches['rsa_verify']} rsa_verify launches for one group "
            "plan")
    require(attrs["rsa_host"] == 0 and attrs["rsa_batched"] > 0,
            f"rsa_batched {attrs['rsa_batched']}, rsa_host "
            f"{attrs['rsa_host']}: the batch did not answer every check")
    require(groups == plain_groups,
            "the group plan differs with and without the RS256 batch")
    require(verdicts(attrs) == verdicts(plain_attrs),
            f"verdicts {verdicts(attrs)} with the batch, "
            f"{verdicts(plain_attrs)} without")
    require(plain_attrs["rsa_batched"] == 0,
            "the run with no batch answered from one")
    return out


def run_k6() -> None:
    """``--k6``: phases 1 and 15 alone."""
    set_mesh(1)
    smi, _lib, _rate, _floor = setup()
    check_k6()
    rs256_path()
    print(smi, flush=True)


def run_simlab() -> None:
    """``--simlab``: phases 1 and 12 alone, for iterating on the lab."""
    set_mesh(1)
    smi, _lib, _rate, _floor = setup()
    simlab_path()
    print(smi, flush=True)


def run_sysfs() -> None:
    """``--sysfs``: phases 1 and 13 alone, for iterating on the sysfs
    backend."""
    set_mesh(1)
    smi, _lib, _rate, _floor = setup()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        sysfs_phase(tmp, smi)
    print(smi, flush=True)


def run_analysis() -> None:
    """``--analysis``: phase 14 alone, its inventory held to every launch
    counter (no phase before it launched anything)."""
    from tpu_cc_manager_torch.kernels import LAUNCHES

    smi = nvidia_smi()
    analysis_phase(smi, {name: 1 for name in LAUNCHES})
    print(smi, flush=True)


def run_multi_card() -> None:
    """``--multi-card``: phase 8 (e) alone, on every visible card."""
    from tpu_cc_manager_torch.kernels import _build

    smi = nvidia_smi()
    finding(phase="setup", torch=torch.__version__, cuda=torch.version.cuda,
            devices=[torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())],
            nvidia_smi=smi)
    _build.library()
    require(multi_card_phase()["ran"], "--multi-card needs two cards")
    set_mesh(1)
    print(smi, flush=True)


MODES = {(): run, ("--k1",): run_k1, ("--k2k3",): run_k2k3,
         ("--k6",): run_k6,
         ("--simlab",): run_simlab, ("--sysfs",): run_sysfs,
         ("--analysis",): run_analysis, ("--multi-card",): run_multi_card}


def main(argv: Tuple[str, ...] = ()) -> int:
    if tuple(argv) not in MODES:
        print("usage: python3 chip_smoke.py "
              "[--k1 | --k2k3 | --k6 | --simlab | --sysfs | --analysis | "
              "--multi-card]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        MODES[tuple(argv)]()
    except Exception as e:  # every phase's failure ends the run here
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # the default run drives cuda:0 only; --multi-card drives every card
    multi = tuple(argv) == ("--multi-card",)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count() if multi else 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(tuple(sys.argv[1:])))
