"""Single-device compile-check entry of the PyTorch port.

The counterpart of ``__graft_entry__.entry()``: the planner is the
system's flagship program, and ``entry()`` returns its legacy core,
``fleet_plan`` (kernel K3: K1 with every row valid and one pool), with
example inputs shaped like a 256-node / 16-slice fleet on the planner's
device. The same numpy seed gives the same fleet as the reference's.

The multi-device dry run (``dryrun_multichip``) waits for the mesh
combines (K4), which become ``torch.distributed`` collectives.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from tpu_cc_manager_torch.plan import MODE_CODES, _planner_device, fleet_plan


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
