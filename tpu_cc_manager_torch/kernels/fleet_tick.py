"""K1, the fleet tick kernel, and K3, the legacy ``fleet_plan`` on it.

Replaces ``tpu_cc_manager/plan.py::fleet_tick`` (plan.py:790-884, with
``_slice_outputs`` :664-686 and ``_seg_minmax`` :655-661) and
``plan.py::fleet_plan`` (:689-725), jitted XLA programs in the JAX
package, with the CUDA kernel in ``csrc/fleet_tick.cu``.

Bound on an H100: bytes. Each row reads 32 B of columns and writes 7 mask
bytes; the arithmetic is a few dozen integer operations. At
nb = 1,048,576 that is 41 MiB, about 13 us at 3.35 TB/s; the kernel also
moves its [6, num_slots] slot scratch. Design (three launches: init, one
grid-stride row pass with shared-memory pool counters and atomic slot
min/max, epilogue) and the index rules it keeps: the head of
``csrc/fleet_tick.cu``. Times on the card: PERF.md.

:func:`fleet_tick_partial` is K1's partial form for one shard of a
mesh: the row pass over the shard's rows with the global slot and pool
widths, its raw counts and slot min/max written into the shard's row of
the mesh's partial buffers, no epilogue. K4 (``kernels/mesh_combine.py``)
combines the shards' rows.

:func:`fleet_tick_block` and :func:`fleet_plan` launch the kernel for a
CUDA tensor and run the plain PyTorch version (:func:`fleet_tick_reference`)
for a CPU tensor; any other device raises. Outputs stay on the input's
device: ``bool`` masks and verdicts, ``int32`` counts, under the JAX
package's keys.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tpu_cc_manager_torch.kernels import LAUNCHES, _build

#: the codes csrc/fleet_tick.cu compiles in; they equal plan.N_MODES,
#: plan.MODE_CODES["unknown"], plan.MODE_CODES["failed"] and
#: plan.DOCTOR_UNREPORTED / DOCTOR_FAILING
N_MODES = 6
MODE_UNKNOWN = 0
MODE_FAILED = 5
DOCTOR_UNREPORTED = 0
DOCTOR_FAILING = 2

#: row order of the column block (plan.COLS_ORDER)
N_COLS = 8

MASK_KEYS = ("needs_flip", "failed", "flipping", "doctor_failing",
             "doctor_unreported", "stale_evidence", "eligible")

#: dynamic shared memory one CTA may have on an H100 (opted in above
#: 48 KiB by the launch); the row pass keeps 12 + 10 * pb int32 there
SMEM_LIMIT_BYTES = 232_448
MAX_POOL_SLOTS = (SMEM_LIMIT_BYTES // 4 - 2 * N_MODES) // 10

_INT32_MIN, _INT32_MAX = -(2 ** 31), 2 ** 31 - 1


def check_pool_slots(num_pools: int) -> None:
    """Raise unless the row pass's shared memory holds ``num_pools``
    pool slots."""
    if not 1 <= num_pools <= MAX_POOL_SLOTS:
        raise ValueError(
            f"fleet_tick: {num_pools} pool slots; the kernel keeps "
            f"12 + 10 * pb int32 per CTA in shared memory, at most "
            f"{SMEM_LIMIT_BYTES} bytes, so 1 <= pb <= {MAX_POOL_SLOTS}")


def _check_int32(value: int, what: str) -> int:
    value = int(value)
    if not _INT32_MIN <= value <= _INT32_MAX:
        raise ValueError(f"fleet_tick: {what}={value} is not an int32")
    return value


def _check_block(block: torch.Tensor, pool_target: torch.Tensor,
                 num_pools: int, num_slots: int) -> None:
    if (block.dtype != torch.int32 or block.dim() != 2
            or block.shape[0] != N_COLS or not block.is_contiguous()):
        raise ValueError(
            "fleet_tick: the column block must be a contiguous int32 "
            f"[{N_COLS}, n] tensor, got {block.dtype} "
            f"{tuple(block.shape)}")
    if block.shape[1] > _INT32_MAX:
        raise ValueError(f"fleet_tick: {block.shape[1]} rows exceed int32")
    if (pool_target.dtype != torch.int32
            or tuple(pool_target.shape) != (num_pools,)
            or not pool_target.is_contiguous()):
        raise ValueError(
            "fleet_tick: pool_target must be a contiguous int32 "
            f"[{num_pools}] tensor, got {pool_target.dtype} "
            f"{tuple(pool_target.shape)}")
    if pool_target.device != block.device:
        raise ValueError(
            f"fleet_tick: pool_target on {pool_target.device}, "
            f"block on {block.device}")
    check_pool_slots(num_pools)
    if not 1 <= num_slots <= _INT32_MAX:
        raise ValueError(f"fleet_tick: num_slots={num_slots}")


def unpack_aggregates(agg: torch.Tensor, slice_out: torch.Tensor,
                      pb: int) -> Dict[str, torch.Tensor]:
    """The aggregate outputs under their keys, from K1's ``agg``
    (``int32[12 + 12 * pb]``) and ``slice_out`` (``bool[2, num_slots]``),
    as K1's and K4's epilogues write them."""
    h = 2 * N_MODES
    return {
        "mode_counts": agg[:N_MODES],
        "desired_counts": agg[N_MODES:h],
        "pool_nodes": agg[h:h + pb],
        "pool_converged": agg[h + pb:h + 2 * pb],
        "pool_failed": agg[h + 2 * pb:h + 3 * pb],
        "pool_eligible": agg[h + 3 * pb:h + 4 * pb],
        # agg[h + 4 * pb:h + 10 * pb] is the pool x mode histogram
        "pool_skew": agg[h + 10 * pb:h + 11 * pb],
        "pool_divergent": agg[h + 11 * pb:h + 12 * pb],
        "slice_coherent": slice_out[0],
        "slice_half_flipped": slice_out[1],
    }


def _unpack(masks: torch.Tensor, agg: torch.Tensor,
            slice_out: torch.Tensor, pb: int) -> Dict[str, torch.Tensor]:
    out = {key: masks[j] for j, key in enumerate(MASK_KEYS)}
    out.update(unpack_aggregates(agg, slice_out, pb))
    return out


def counts_len(num_pools: int) -> int:
    """Entries of K1's summed head (the part the rows add into, and a
    shard's partial counts): the two mode histograms and the pool
    counters and pool x mode histogram."""
    return 2 * N_MODES + 10 * num_pools


def _launch(block: torch.Tensor, pool_target: torch.Tensor, now_s: int,
            stale_s: int, num_pools: int,
            num_slots: int) -> Dict[str, torch.Tensor]:
    lib = _build.library()
    dev = block.device
    n = int(block.shape[1])
    masks = torch.empty((len(MASK_KEYS), n), dtype=torch.bool, device=dev)
    agg = torch.empty(2 * N_MODES + 12 * num_pools, dtype=torch.int32,
                      device=dev)
    # scratch: its memory goes back to the caching allocator on return,
    # which hands it out again only to work ordered after this stream
    slots = torch.empty((6, num_slots), dtype=torch.int32, device=dev)
    slice_out = torch.empty((2, num_slots), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = lib.tcc_fleet_tick(
            block.data_ptr(), n, pool_target.data_ptr(), num_pools,
            num_slots, now_s, stale_s, masks.data_ptr(), agg.data_ptr(),
            slots.data_ptr(), slice_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fleet_tick launch")
    return _unpack(masks, agg, slice_out, num_pools)


def fleet_tick_block(block: torch.Tensor, pool_target: torch.Tensor,
                     now_s: int, stale_after_s: int, *, num_pools: int,
                     num_slots: int) -> Dict[str, torch.Tensor]:
    """One fleet tick over ``block`` (``int32[8, n]`` in
    ``plan.COLS_ORDER``) with ``pool_target`` (``int32[num_pools]``):
    the seven per-row masks, the mode histograms, the per-pool counts and
    the per-slot slice verdicts over ``num_slots`` slots. Launches K1 for
    a CUDA block, runs :func:`fleet_tick_reference` for a CPU block."""
    _check_block(block, pool_target, num_pools, num_slots)
    now_s = _check_int32(now_s, "now_s")
    stale_after_s = _check_int32(stale_after_s, "stale_after_s")
    if block.device.type == "cpu":
        return fleet_tick_reference(block, pool_target, now_s,
                                    stale_after_s, num_pools=num_pools,
                                    num_slots=num_slots)
    if block.device.type != "cuda":
        raise ValueError(f"fleet_tick: no kernel for {block.device}")
    out = _launch(block, pool_target, now_s, stale_after_s, num_pools,
                  num_slots)
    LAUNCHES["fleet_tick"] += 1
    return out


def _check_partial_out(counts: torch.Tensor, slots: torch.Tensor,
                       device: torch.device, num_pools: int,
                       num_slots: int) -> None:
    for name, buf, shape in (("counts", counts, (counts_len(num_pools),)),
                             ("slots", slots, (6, num_slots))):
        if (buf.dtype != torch.int32 or tuple(buf.shape) != shape
                or not buf.is_contiguous() or buf.device != device):
            raise ValueError(
                f"fleet_tick_partial: {name} must be a contiguous int32 "
                f"{list(shape)} tensor on {device}, got {buf.dtype} "
                f"{tuple(buf.shape)} on {buf.device}")


def fleet_tick_partial(block: torch.Tensor, pool_target: torch.Tensor,
                       now_s: int, stale_after_s: int, *, num_pools: int,
                       num_slots: int, counts: torch.Tensor,
                       slots: torch.Tensor) -> torch.Tensor:
    """K1's partial form over one shard's ``block`` (``int32[8, rows]``,
    global slice and pool ids): writes the shard's raw counts into
    ``counts`` (``int32[counts_len(num_pools)]``) and its slot min/max
    into ``slots`` (``int32[6, num_slots]``), and returns its seven mask
    rows (``bool[7, rows]``, in ``MASK_KEYS`` order). No epilogue runs.
    Launches the kernel for a CUDA block, runs
    :func:`fleet_tick_partial_reference` for a CPU block."""
    _check_block(block, pool_target, num_pools, num_slots)
    _check_partial_out(counts, slots, block.device, num_pools, num_slots)
    now_s = _check_int32(now_s, "now_s")
    stale_after_s = _check_int32(stale_after_s, "stale_after_s")
    if block.device.type == "cpu":
        masks, c, sl = fleet_tick_partial_reference(
            block, pool_target, now_s, stale_after_s, num_pools=num_pools,
            num_slots=num_slots)
        counts.copy_(c)
        slots.copy_(sl)
        return masks
    if block.device.type != "cuda":
        raise ValueError(f"fleet_tick_partial: no kernel for {block.device}")
    lib = _build.library()
    n = int(block.shape[1])
    masks = torch.empty((len(MASK_KEYS), n), dtype=torch.bool,
                        device=block.device)
    with torch.cuda.device(block.device):
        rc = lib.tcc_fleet_tick_partial(
            block.data_ptr(), n, pool_target.data_ptr(), num_pools,
            num_slots, now_s, stale_after_s, masks.data_ptr(),
            counts.data_ptr(), slots.data_ptr(),
            torch.cuda.current_stream(block.device).cuda_stream)
    _build.check(rc, "fleet_tick_partial launch")
    LAUNCHES["fleet_tick_partial"] += 1
    return masks


def _plan_block(desired: torch.Tensor, observed: torch.Tensor,
                slice_ids: torch.Tensor) -> torch.Tensor:
    """The K1 block for ``fleet_plan``'s three columns: pool 0, no taint,
    doctor unreported, no evidence, every row valid."""
    for name, col in (("desired", desired), ("observed", observed),
                      ("slice_ids", slice_ids)):
        if (col.dtype != torch.int32 or col.dim() != 1
                or col.shape != desired.shape
                or col.device != desired.device):
            raise ValueError(
                f"fleet_plan: {name} must be int32 [n] on one device with "
                f"the others, got {col.dtype} {tuple(col.shape)} on "
                f"{col.device}")
    block = torch.zeros((N_COLS, desired.shape[0]), dtype=torch.int32,
                        device=desired.device)
    block[0] = desired
    block[1] = observed
    block[2] = slice_ids
    block[6] = -1
    block[7] = 1
    return block


_PLAN_KEYS = ("needs_flip", "failed", "mode_counts", "desired_counts",
              "slice_coherent", "slice_half_flipped")


def fleet_plan(desired: torch.Tensor, observed: torch.Tensor,
               slice_ids: torch.Tensor, *,
               num_slices: int) -> Dict[str, torch.Tensor]:
    """K3, the legacy core (``plan.py::fleet_plan``): divergence, the two
    mode histograms and the slice audit over ``num_slices`` slots, with
    every row counted. K1 with valid = 1, one pool and the slot width set
    to ``num_slices``; launches it for CUDA tensors, runs
    :func:`fleet_plan_reference` for CPU tensors."""
    block = _plan_block(desired, observed, slice_ids)
    target = torch.zeros(1, dtype=torch.int32, device=block.device)
    _check_block(block, target, 1, num_slices)
    if block.device.type == "cpu":
        out = fleet_tick_reference(block, target, 0, 0, num_pools=1,
                                   num_slots=num_slices)
    elif block.device.type == "cuda":
        out = _launch(block, target, 0, 0, 1, num_slices)
        LAUNCHES["fleet_plan"] += 1
    else:
        raise ValueError(f"fleet_plan: no kernel for {block.device}")
    return {key: out[key] for key in _PLAN_KEYS}


# ------------------------------------------------------ plain versions


def _scatter_index(idx: torch.Tensor, size: int):
    """JAX's scatter index rule: a negative index counts once from the
    end, one still out of range is dropped. Returns (safe index, ok)."""
    wrapped = torch.where(idx < 0, idx + size, idx)
    ok = (wrapped >= 0) & (wrapped < size)
    return wrapped.clamp(0, size - 1).long(), ok


def _scatter_add(size: int, idx: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    safe, ok = _scatter_index(idx, size)
    zero = torch.zeros((), dtype=torch.int32, device=idx.device)
    out = torch.zeros(size, dtype=torch.int32, device=idx.device)
    return out.index_add_(0, safe, torch.where(ok, val.to(torch.int32),
                                               zero))


def _seg_reduce(size: int, idx: torch.Tensor, val: torch.Tensor,
                init: int, reduce: str) -> torch.Tensor:
    safe, ok = _scatter_index(idx, size)
    fill = torch.full((), init, dtype=torch.int32, device=idx.device)
    out = torch.full((size,), init, dtype=torch.int32, device=idx.device)
    return out.scatter_reduce_(0, safe, torch.where(ok, val, fill),
                               reduce, include_self=True)


def fleet_tick_partial_reference(
        block: torch.Tensor, pool_target: torch.Tensor, now_s: int,
        stale_after_s: int, *, num_pools: int, num_slots: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K1's partial form: ``plan.py::
    fleet_tick`` up to its combine, written with ``index_add_`` and
    ``scatter_reduce_`` (``amin``/``amax``, ``include_self=True``).
    Returns ``(masks bool[7, n], counts int32[counts_len(num_pools)],
    slots int32[6, num_slots])`` on ``block``'s device."""
    (desired, observed, slice_ids, pool_ids, taint, doctor, ev_ts,
     valid) = block.unbind(0)
    dev = block.device
    is_valid = valid > 0
    known = (desired != MODE_UNKNOWN) & is_valid
    needs_flip = (desired != observed) & known
    failed = (observed == MODE_FAILED) & is_valid
    flipping = (taint > 0) & is_valid
    doctor_failing = (doctor == DOCTOR_FAILING) & is_valid
    doctor_unreported = (doctor == DOCTOR_UNREPORTED) & is_valid
    now = torch.tensor(now_s, dtype=torch.int32, device=dev)
    stale_evidence = ((ev_ts >= 0) & ((now - ev_ts) > stale_after_s)
                      & is_valid)

    pw = torch.where(pool_ids < 0, pool_ids + num_pools, pool_ids)
    target = pool_target[pw.clamp(0, num_pools - 1).long()]
    converged = (observed == target) & (desired == target) & known
    eligible = ~converged & is_valid & ~flipping & ~doctor_failing

    # the pool x mode histogram drops a row whose pool OR mode is out of
    # range; an out-of-range flat index does exactly that
    p_safe, p_ok = _scatter_index(pool_ids, num_pools)
    m_safe, m_ok = _scatter_index(observed, N_MODES)
    flat = torch.where(p_ok & m_ok, p_safe * N_MODES + m_safe,
                       torch.full_like(p_safe, num_pools * N_MODES))
    counts = torch.cat([
        _scatter_add(N_MODES, observed, valid),
        _scatter_add(N_MODES, desired, valid),
        _scatter_add(num_pools, pool_ids, valid),
        _scatter_add(num_pools, pool_ids, converged),
        _scatter_add(num_pools, pool_ids, failed),
        _scatter_add(num_pools, pool_ids, eligible),
        _scatter_add(num_pools * N_MODES, flat, valid),
    ])

    at_target = ((observed == desired) & known).to(torch.int32)
    slots = torch.stack([
        _seg_reduce(num_slots, slice_ids, desired, _INT32_MAX, "amin"),
        _seg_reduce(num_slots, slice_ids, desired, _INT32_MIN, "amax"),
        _seg_reduce(num_slots, slice_ids, observed, _INT32_MAX, "amin"),
        _seg_reduce(num_slots, slice_ids, observed, _INT32_MIN, "amax"),
        _seg_reduce(num_slots, slice_ids, at_target, 1, "amin"),
        _seg_reduce(num_slots, slice_ids, at_target, 0, "amax"),
    ])
    masks = torch.stack([needs_flip, failed, flipping, doctor_failing,
                         doctor_unreported, stale_evidence, eligible])
    return masks, counts, slots


def epilogue_reference(counts: torch.Tensor, slots: torch.Tensor,
                       num_pools: int) -> Dict[str, torch.Tensor]:
    """K1's epilogue in plain PyTorch, over the summed ``counts``
    (``int32[counts_len(num_pools)]``) and the reduced ``slots``
    (``int32[6, num_slots]``): the aggregates under their keys, with
    ``pool_skew``, ``pool_divergent`` and the two slice verdicts."""
    h, pb = 2 * N_MODES, num_pools
    pool_nodes = counts[h:h + pb]
    pool_converged = counts[h + pb:h + 2 * pb]
    pool_hist = counts[h + 4 * pb:h + 10 * pb].view(pb, N_MODES)
    d_mn, d_mx, o_mn, o_mx, at_mn, at_mx = slots.unbind(0)
    return {
        "mode_counts": counts[:N_MODES],
        "desired_counts": counts[N_MODES:h],
        "pool_nodes": pool_nodes,
        "pool_converged": pool_converged,
        "pool_failed": counts[h + 2 * pb:h + 3 * pb],
        "pool_eligible": counts[h + 3 * pb:h + 4 * pb],
        "pool_skew": pool_nodes - pool_hist.amax(dim=1),
        "pool_divergent": pool_nodes - pool_converged,
        "slice_coherent": (d_mn == d_mx) & (o_mn == o_mx),
        "slice_half_flipped": (d_mn == d_mx) & (at_mn == 0) & (at_mx == 1),
    }


def fleet_tick_reference(block: torch.Tensor, pool_target: torch.Tensor,
                         now_s: int, stale_after_s: int, *, num_pools: int,
                         num_slots: int) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of K1: :func:`fleet_tick_partial_reference`
    over every row, then :func:`epilogue_reference`, on whatever device
    ``block`` is on."""
    masks, counts, slots = fleet_tick_partial_reference(
        block, pool_target, now_s, stale_after_s, num_pools=num_pools,
        num_slots=num_slots)
    out = {key: masks[j] for j, key in enumerate(MASK_KEYS)}
    out.update(epilogue_reference(counts, slots, num_pools))
    return out


def fleet_plan_reference(desired: torch.Tensor, observed: torch.Tensor,
                         slice_ids: torch.Tensor, *,
                         num_slices: int) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of K3: :func:`fleet_tick_reference` on
    the block :func:`fleet_plan` builds."""
    block = _plan_block(desired, observed, slice_ids)
    target = torch.zeros(1, dtype=torch.int32, device=block.device)
    out = fleet_tick_reference(block, target, 0, 0, num_pools=1,
                               num_slots=num_slices)
    return {key: out[key] for key in _PLAN_KEYS}
