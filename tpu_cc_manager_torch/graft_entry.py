"""Compile-check entry and multi-shard dry run of the PyTorch port.

The counterparts of ``__graft_entry__.py``: the planner is the system's
flagship program.

- ``entry()`` returns its legacy core, ``fleet_plan`` (kernel K3), with
  example inputs shaped like a 256-node / 16-slice fleet on the
  planner's device.
- ``dryrun_multichip(n)`` shards a small fleet over n shards placed
  round-robin on the visible cards (all on one card when there is one),
  runs K3 on every shard with its local slices, one launch per card
  (``fleet_plan_shards``), sums the shards' ``mode_counts`` with K4's
  counts-only form on shard 0's card (the reference's ``psum``), and
  checks the result against one unsharded K3 over the global slice ids.
  On one card that is three launches.

The same numpy seeds give the same fleets as the reference's.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from tpu_cc_manager_torch.kernels.fleet_tick import (
    MAX_PLAN_SHARDS, fleet_plan_shards,
)
from tpu_cc_manager_torch.kernels.mesh_combine import mesh_sum
from tpu_cc_manager_torch.plan import (
    _DISPATCH_LOCK, MODE_CODES, N_MODES, _by_device, _planner_device,
    _shard_devices, fleet_plan,
)


def _example_fleet(n_nodes: int, n_slices: int, seed: int = 0, *,
                   device: torch.device) -> Tuple[torch.Tensor, ...]:
    rng = np.random.default_rng(seed)
    desired = rng.integers(1, 5, size=n_nodes).astype(np.int32)  # off..ici
    observed = desired.copy()
    # perturb: some nodes lag desired, a few failed
    lag = rng.random(n_nodes) < 0.2
    observed[lag] = rng.integers(1, 5, size=int(lag.sum())).astype(np.int32)
    fail = rng.random(n_nodes) < 0.03
    observed[fail] = MODE_CODES["failed"]
    slice_ids = (np.arange(n_nodes) % n_slices).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (desired, observed, slice_ids))


def entry(device: Union[None, str, torch.device] = None) -> Tuple[
        Callable[..., Dict[str, torch.Tensor]], Tuple[torch.Tensor, ...]]:
    """-> (fn, example_args); ``fn(*example_args)`` runs K3 on the
    planner's device (``cuda:0`` unless asked otherwise)."""
    n_nodes, n_slices = 256, 16
    fn = partial(fleet_plan, num_slices=n_slices)
    return fn, _example_fleet(n_nodes, n_slices,
                              device=_planner_device(device))


def dryrun_multichip(n_devices: int,
                     device: Union[None, str, torch.device] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shard a tiny fleet over ``n_devices`` shards; one step, checked
    against the unsharded computation. Returns ``(needs_flip,
    mode_counts, slice_coherent)`` as numpy arrays: the per-node mask and
    the per-local-slice verdicts concatenated in shard order, and the
    fleet's mode histogram. Raises ``AssertionError`` when the sharded
    step and the unsharded one disagree. At most 64 shards, as the
    planner's mesh (one K3 launch takes up to 64)."""
    if not 1 <= n_devices <= MAX_PLAN_SHARDS:
        raise ValueError(
            f"dryrun_multichip: {n_devices} shards; the planner's mesh "
            f"takes 1 to {MAX_PLAN_SHARDS}")
    root = _planner_device(device)
    mesh = _shard_devices(root, n_devices)
    # 8 nodes and 2 slices per shard; slices are shard-local (a slice's
    # members live in one shard, as slice coordination is slice-local in
    # the agent), so each shard plans over its own 2 slice slots
    nodes_per_dev, slices_per_dev = 8, 2
    n_nodes = nodes_per_dev * n_devices
    desired, observed, _ = _example_fleet(n_nodes, 1, seed=1,
                                          device=torch.device("cpu"))
    slice_local = np.repeat(np.arange(slices_per_dev, dtype=np.int32),
                            nodes_per_dev // slices_per_dev)
    local_ids = torch.from_numpy(slice_local)
    partial = torch.empty((n_devices, N_MODES), dtype=torch.int32,
                          device=root)
    plans = [None] * n_devices
    with _DISPATCH_LOCK:
        # one K3 launch per card over its shards; on shard 0's card with
        # every shard, the launch writes the partial rows in place, else
        # each card's rows are copied there, as the mesh tick's are
        for dev, ids in _by_device(mesh).items():
            d, o, ids_dev = (t.to(dev) for t in (desired, observed,
                                                  local_ids))
            cols = [(d[i * nodes_per_dev:(i + 1) * nodes_per_dev],
                     o[i * nodes_per_dev:(i + 1) * nodes_per_dev], ids_dev)
                    for i in ids]
            in_place = dev == root and len(ids) == n_devices
            out = fleet_plan_shards(cols, num_slices=slices_per_dev,
                                    mode_counts=partial if in_place else None)
            for i, plan_i in zip(ids, out):
                if not in_place:
                    partial[i].copy_(plan_i["mode_counts"])
                plans[i] = plan_i
        # fleet-wide aggregates: K4's counts-only form, the psum
        mode_counts = mesh_sum(partial).cpu().numpy()
        needs_flip = np.concatenate(
            [p["needs_flip"].cpu().numpy() for p in plans])
        slice_coherent = np.concatenate(
            [p["slice_coherent"].cpu().numpy() for p in plans])

    # cross-check against the unsharded computation over global slice ids
    global_ids = np.concatenate(
        [slice_local + i * slices_per_dev for i in range(n_devices)])
    with _DISPATCH_LOCK:
        ref = fleet_plan(desired.to(root), observed.to(root),
                         torch.from_numpy(global_ids).to(root),
                         num_slices=slices_per_dev * n_devices)
        ref = {key: val.cpu().numpy() for key, val in ref.items()}
    np.testing.assert_array_equal(needs_flip, ref["needs_flip"])
    np.testing.assert_array_equal(mode_counts, ref["mode_counts"])
    np.testing.assert_array_equal(slice_coherent, ref["slice_coherent"])
    if int(mode_counts.sum()) != n_nodes:
        raise AssertionError(
            f"mode_counts sums to {int(mode_counts.sum())}, not {n_nodes}")
    return needs_flip, mode_counts, slice_coherent
