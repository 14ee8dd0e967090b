"""K4, the mesh combine of the sharded planner tick.

Replaces the collectives of the JAX package's sharded tick: the ``psum``
of the seven aggregates in ``tpu_cc_manager/plan.py::fleet_tick``
(plan.py:864-871) and the ``pmin``/``pmax`` of the six slot arrays in
``_slice_outputs`` (:677-683), with the epilogue after them; and, in its
counts-only form, the ``psum`` of ``mode_counts`` in
``__graft_entry__.py::fleet_step`` (:114). The CUDA kernel is
``csrc/mesh_combine.cu``.

One process drives every shard of the port's mesh, as one controller
drives the reference's: each shard writes K1's partial form
(:func:`~tpu_cc_manager_torch.kernels.fleet_tick.fleet_tick_partial`)
into its row of two buffers on the root card, and K4 reduces the rows
there, the epilogue included. No library collective is involved.

Bound on an H100: bytes. At S = 8 shards, 1,048,576 slots and pb = 8 it
reads about 201 MB of partials and writes about 2 MB, some 0.06 ms at
3.35 TB/s. Times on the card: PERF.md.

:func:`mesh_combine` and :func:`mesh_sum` launch the kernel for CUDA
tensors and run the plain PyTorch versions (:func:`mesh_combine_reference`,
:func:`mesh_sum_reference`) for CPU tensors; any other device raises.
"""

from __future__ import annotations

from typing import Dict

import torch

from tpu_cc_manager_torch.kernels import LAUNCHES, _build
from tpu_cc_manager_torch.kernels.fleet_tick import (
    check_pool_slots, counts_len, epilogue_reference, unpack_aggregates,
)

_INT32_MAX = 2 ** 31 - 1


def _check(counts: torch.Tensor, slots: torch.Tensor, num_pools: int) -> None:
    check_pool_slots(num_pools)
    if (counts.dtype != torch.int32 or counts.dim() != 2
            or counts.shape[1] != counts_len(num_pools)
            or not counts.is_contiguous()):
        raise ValueError(
            "mesh_combine: counts must be a contiguous int32 "
            f"[S, {counts_len(num_pools)}] tensor, got {counts.dtype} "
            f"{tuple(counts.shape)}")
    if (slots.dtype != torch.int32 or slots.dim() != 3
            or slots.shape[1] != 6 or not slots.is_contiguous()):
        raise ValueError(
            "mesh_combine: slots must be a contiguous int32 "
            f"[S, 6, num_slots] tensor, got {slots.dtype} "
            f"{tuple(slots.shape)}")
    if counts.shape[0] != slots.shape[0] or counts.shape[0] < 1:
        raise ValueError(
            f"mesh_combine: {counts.shape[0]} count rows and "
            f"{slots.shape[0]} slot rows; both must be S >= 1")
    if counts.device != slots.device:
        raise ValueError(
            f"mesh_combine: counts on {counts.device}, slots on "
            f"{slots.device}")
    if not 1 <= slots.shape[2] <= _INT32_MAX:
        raise ValueError(f"mesh_combine: {slots.shape[2]} slots")


def mesh_combine(counts: torch.Tensor, slots: torch.Tensor, *,
                 num_pools: int) -> Dict[str, torch.Tensor]:
    """Combine S shards' partials: ``counts`` (``int32[S,
    counts_len(num_pools)]``) summed, ``slots`` (``int32[S, 6,
    num_slots]``) reduced by min/max, then K1's epilogue. Returns the
    tick's aggregate outputs under the JAX package's keys (the counts,
    ``pool_skew``, ``pool_divergent``, ``slice_coherent``,
    ``slice_half_flipped``) on the inputs' device. Launches K4 for CUDA
    tensors, runs :func:`mesh_combine_reference` for CPU tensors."""
    _check(counts, slots, num_pools)
    dev = counts.device
    if dev.type == "cpu":
        return mesh_combine_reference(counts, slots, num_pools=num_pools)
    if dev.type != "cuda":
        raise ValueError(f"mesh_combine: no kernel for {dev}")
    shards, num_slots = int(slots.shape[0]), int(slots.shape[2])
    agg = torch.empty(counts_len(num_pools) + 2 * num_pools,
                      dtype=torch.int32, device=dev)
    slice_out = torch.empty((2, num_slots), dtype=torch.bool, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.tcc_mesh_combine(
            counts.data_ptr(), slots.data_ptr(), shards, num_pools,
            num_slots, agg.data_ptr(), slice_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "mesh_combine launch")
    LAUNCHES["mesh_combine"] += 1
    return unpack_aggregates(agg, slice_out, num_pools)


def mesh_sum(partials: torch.Tensor) -> torch.Tensor:
    """K4's counts-only form: the int32 sum over dim 0 of ``partials``
    (``int32[S, m]``), wrapping as ``psum`` does. Launches K4 for a CUDA
    tensor, runs :func:`mesh_sum_reference` for a CPU tensor."""
    if (partials.dtype != torch.int32 or partials.dim() != 2
            or partials.shape[0] < 1 or not partials.is_contiguous()
            or partials.shape[1] > _INT32_MAX):
        raise ValueError(
            "mesh_sum: partials must be a contiguous int32 [S >= 1, m] "
            f"tensor, got {partials.dtype} {tuple(partials.shape)}")
    dev = partials.device
    if dev.type == "cpu":
        return mesh_sum_reference(partials)
    if dev.type != "cuda":
        raise ValueError(f"mesh_sum: no kernel for {dev}")
    shards, m = int(partials.shape[0]), int(partials.shape[1])
    out = torch.empty(m, dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.tcc_mesh_sum(partials.data_ptr(), shards, m, out.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "mesh_sum launch")
    LAUNCHES["mesh_combine"] += 1
    return out


# ------------------------------------------------------ plain versions


def mesh_sum_reference(partials: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K4's counts-only form, on any
    device: the sum over dim 0, wrapped to int32."""
    return partials.sum(dim=0, dtype=torch.int64).to(torch.int32)


def mesh_combine_reference(counts: torch.Tensor, slots: torch.Tensor, *,
                           num_pools: int) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of K4, on any device: ``sum`` of the
    counts and ``amin``/``amax`` of the slot rows over dim 0, then K1's
    epilogue (:func:`~tpu_cc_manager_torch.kernels.fleet_tick.
    epilogue_reference`)."""
    mins = slots.amin(dim=0)
    maxs = slots.amax(dim=0)
    reduced = torch.stack([mins[0], maxs[1], mins[2], maxs[3], mins[4],
                           maxs[5]])
    return epilogue_reference(mesh_sum_reference(counts), reduced,
                              num_pools)
