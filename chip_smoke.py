#!/usr/bin/env python3
"""Drive the PyTorch port of the fleet planner on one NVIDIA GPU and check it.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device, ``nvcc`` and the repository's ``tpu_cc_manager_torch`` package; it
exits non-zero without them, and whenever any phase fails.

1. Build: the CUDA kernels compile from ``tpu_cc_manager_torch/csrc``;
   the launch floor (one empty kernel through the same ctypes route,
   timed like every kernel).
2. Kernels against their plain PyTorch versions, on the card, at the
   shapes the main path gives them: K1 ``fleet_tick`` at 131,072 and
   1,048,576 rows (the 100k bucket pads 24 % of its rows onto slot
   nb - 1), a padded fleet with empty slots, out-of-range indices, every
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

``python3 chip_smoke.py --k1`` runs phases 1 and 2's K1, K1-partial and
K4 work alone, to compare two versions of K1 within one chip call.
``python3 chip_smoke.py --k2k3`` runs phase 1 and the K2 and K3 checks of
phases 2 and 8 (a) alone, with the row count where K3's one-CTA kernel
and K1's route cross (the ``k3_crossover`` line), to compare two
versions of K2 and K3 within one chip call.
``python3 chip_smoke.py --multi-card`` runs phase 8 (e) alone, on every
visible card (it fails with one). Phases 1-7 run on one shard
(``TPU_CC_PLANNER_MESH=1``). Launch counts
are set to 0 just before phase 3 and read just after phase 5, set to 0
again just before phase 7 and read just after it, and again just before
phase 8's (b) and read just after its (d): each kernel must have been
launched on its path, K2 exactly once per card per incremental tick and
K3 once per ``entry()`` call and, in the dry run, once per card plus the
cross-check. Lines before the last are findings (one JSON
object each), the ``{"kernels": [...]}`` line and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``, whose
``count`` is 1 (the cards this run drives) and, under ``--multi-card``,
the number of visible cards.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
        # 8-pool policy scan, the 1M session geometry, a padded fleet with
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
    psnap = scratch.encoding.snapshot()
    rows = scratch.encoding.row_map()
    pool_rows = np.zeros(psnap.n_nodes, np.int64)
    for pid, (_, _, members) in enumerate(pools):
        for node in members:
            pool_rows[rows[node["metadata"]["name"]]] = pid
    pb = plan.bucket_pools(N_POOLS)
    target = np.full(pb, plan.MODE_CODES["on"], np.int32)
    exp = host_expectation(psnap, pool_rows, target, now_s, stale_s)
    for pid, (pname, _, _) in enumerate(pools):
        want = {"nodes": int(exp["pool_nodes"][pid]),
                "converged": int(exp["pool_converged"][pid]),
                "failed": int(exp["pool_failed"][pid]),
                "divergent": int(exp["pool_nodes"][pid]
                                 - exp["pool_converged"][pid]),
                "skew": int(exp["pool_skew"][pid]),
                "eligible": int(exp["pool_eligible"][pid])}
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

    rows = []
    for name, (source, replaces) in KERNELS.items():
        # the largest shape the main path gives each kernel
        main = max(measured[name],
                   key=lambda r: r.get("rows", r.get("kb", 0)))
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in measured[name]),
            "max_abs_diff": max(r["max_abs_err"] for r in measured[name]),
            "shape": main["shape"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main.get("library_ms"),
            "launch_floor_ms": floor,
            "shapes": measured[name],
        })
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
         ("--multi-card",): run_multi_card}


def main(argv: Tuple[str, ...] = ()) -> int:
    if tuple(argv) not in MODES:
        print("usage: python3 chip_smoke.py [--k1 | --k2k3 | --multi-card]",
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
