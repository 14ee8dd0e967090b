"""Hand-written Hopper kernels of the port and their launch counts.

Each wrapper adds one to its entry in :data:`LAUNCHES` where it launches
its CUDA kernel, and nowhere else: a run that reads the counts after
driving the planner or a mode flip shows which kernels the path really
went through. The plain PyTorch versions (used for CPU tensors) never
count.
"""

from typing import Dict

#: launches per kernel wrapper since process start (or the last
#: :func:`reset_launches`)
LAUNCHES: Dict[str, int] = {"fleet_tick": 0, "fleet_tick_partial": 0,
                            "fleet_plan": 0, "delta_scatter": 0,
                            "probe_add_one": 0, "mesh_combine": 0,
                            "rsa_verify": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
