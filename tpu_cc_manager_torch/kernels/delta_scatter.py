"""K2, the incremental tick's delta scatter.

Replaces ``tpu_cc_manager/plan.py::_scatter_fn``'s scatter
(plan.py:1075-1094), a jitted XLA program over donated buffers, with the
CUDA kernel in ``csrc/delta_scatter.cu``: it writes up to ``kb`` changed
rows of all 8 columns into the session's resident ``int32[8, rows]``
blocks in place. Index ``nb`` is padding; any index outside ``[0, nb)``
changes nothing. The caller guarantees the indices are unique. On a mesh
shard i's block holds the global rows ``[i * rows, (i + 1) * rows)``, and
one launch serves every shard on one card: each index goes to the one
shard that owns it, or nowhere. Unlike the reference's shard, which clips
a foreign index onto its last row (plan.py:1083-1093), no shard can
overwrite a real update.

Bound on an H100: launch overhead. Every index is read once (4 bytes per
slot) and each live slot's 8 values are read and written (64 bytes):
about 0.7 MB at kb = 16,384 with 10,000 live rows for the whole mesh,
which the card's memory rate covers in well under a microsecond. Design:
one thread per delta slot, the shards' block pointers passed by value in
the launch (the head of ``csrc/delta_scatter.cu``). Times on the card:
PERF.md.

:func:`delta_scatter` (one block, at a row offset) and
:func:`delta_scatter_shards` (the shard blocks of one card) launch the
kernel for CUDA tensors and run the plain PyTorch versions
(:func:`delta_scatter_reference`, :func:`delta_scatter_shards_reference`)
for CPU tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from tpu_cc_manager_torch.kernels import LAUNCHES, _build

N_COLS = 8
#: the shard table the launch carries by value (plan's mesh caps S at 64)
MAX_SHARDS = 64
_INT32_LIMIT = 2 ** 31


def _check_operands(idx: torch.Tensor, vals: torch.Tensor,
                    device: torch.device) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(
            "delta_scatter: idx must be a contiguous int32 [kb] tensor, got "
            f"{idx.dtype} {tuple(idx.shape)}")
    if (vals.dtype != torch.int32
            or tuple(vals.shape) != (N_COLS, idx.shape[0])
            or not vals.is_contiguous()):
        raise ValueError(
            "delta_scatter: vals must be a contiguous int32 "
            f"[{N_COLS}, {idx.shape[0]}] tensor, got {vals.dtype} "
            f"{tuple(vals.shape)}")
    if not device == idx.device == vals.device:
        raise ValueError(
            f"delta_scatter: blocks on {device}, idx on {idx.device}, "
            f"vals on {vals.device}")
    if idx.shape[0] * N_COLS >= _INT32_LIMIT:
        raise ValueError("delta_scatter: sizes exceed int32")


def _check_block(block: torch.Tensor) -> None:
    if (block.dtype != torch.int32 or block.dim() != 2
            or block.shape[0] != N_COLS or not block.is_contiguous()):
        raise ValueError(
            "delta_scatter: a block must be a contiguous int32 "
            f"[{N_COLS}, rows] tensor, got {block.dtype} "
            f"{tuple(block.shape)}")
    if block.shape[1] >= _INT32_LIMIT:
        raise ValueError("delta_scatter: sizes exceed int32")


def _launch(table: Sequence[Optional[torch.Tensor]], rows: int, row0: int,
            end: int, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """One K2 launch over ``table`` (shard i's block or None) on the
    operands' card; nothing launches when there is nothing to write."""
    if idx.shape[0] == 0 or rows == 0:
        return
    dev = idx.device
    ptrs = (ctypes.c_void_p * len(table))(
        *(None if b is None else b.data_ptr() for b in table))
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.tcc_delta_scatter(
            ptrs, len(table), rows, row0, end, idx.data_ptr(),
            vals.data_ptr(), int(idx.shape[0]),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "delta_scatter launch")
    LAUNCHES["delta_scatter"] += 1


def delta_scatter(block: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor, row0: int = 0) -> None:
    """``block[c, idx[j] - row0] = vals[c, j]`` for every column ``c`` and
    every ``j`` with ``row0 <= idx[j] < row0 + rows``, in place (``rows``
    is the block's width; ``row0`` is 0 for an unsharded block). Launches
    K2 for CUDA tensors, runs :func:`delta_scatter_reference` for CPU
    tensors."""
    _check_block(block)
    _check_operands(idx, vals, block.device)
    row0 = int(row0)
    if not 0 <= row0 < _INT32_LIMIT:
        raise ValueError(f"delta_scatter: row0={row0} is not an int32 >= 0")
    if block.device.type == "cpu":
        delta_scatter_reference(block, idx, vals, row0)
        return
    if block.device.type != "cuda":
        raise ValueError(f"delta_scatter: no kernel for {block.device}")
    rows = int(block.shape[1])
    _launch([block], rows, row0, row0 + rows, idx, vals)


def _shard_table(blocks: Sequence[torch.Tensor], nb: int,
                 shard_ids: Optional[Sequence[int]]) -> List[int]:
    """Checks the shard blocks against ``nb`` and returns their shard
    numbers."""
    if not 1 <= len(blocks) <= MAX_SHARDS:
        raise ValueError(
            f"delta_scatter_shards: {len(blocks)} blocks; one launch takes "
            f"1 to {MAX_SHARDS} shards")
    for block in blocks:
        _check_block(block)
    rows = int(blocks[0].shape[1])
    if any(int(b.shape[1]) != rows for b in blocks):
        raise ValueError(
            "delta_scatter_shards: blocks of unequal width "
            f"{sorted({int(b.shape[1]) for b in blocks})}")
    devices = {b.device for b in blocks}
    if len(devices) != 1:
        raise ValueError(
            f"delta_scatter_shards: blocks on {sorted(map(str, devices))}; "
            "one launch serves one device")
    nb = int(nb)
    if rows < 1 or nb % rows or not 1 <= nb // rows <= MAX_SHARDS \
            or nb >= _INT32_LIMIT:
        raise ValueError(
            f"delta_scatter_shards: nb={nb} is not 1 to {MAX_SHARDS} "
            f"shards of {rows} rows")
    ids = list(range(len(blocks))) if shard_ids is None else [
        int(i) for i in shard_ids]
    if (len(ids) != len(blocks) or len(set(ids)) != len(ids)
            or not all(0 <= i < nb // rows for i in ids)):
        raise ValueError(
            f"delta_scatter_shards: shard_ids {ids} are not {len(blocks)} "
            f"distinct shards of {nb // rows}")
    return ids


def delta_scatter_shards(blocks: Sequence[torch.Tensor], idx: torch.Tensor,
                         vals: torch.Tensor, nb: int, *,
                         shard_ids: Optional[Sequence[int]] = None) -> None:
    """K2 over the shard blocks of one device: ``blocks[k]`` is shard
    ``shard_ids[k]`` (default ``k``) of a mesh of ``nb`` global rows in
    equal shards of ``rows`` (the blocks' width), holding the rows
    ``[shard * rows, (shard + 1) * rows)``. Each index in ``[0, nb)`` goes
    to the block that owns it, or nowhere when its shard is not among
    ``blocks``; every other index changes nothing. One launch for CUDA
    tensors, :func:`delta_scatter_shards_reference` for CPU tensors."""
    ids = _shard_table(blocks, nb, shard_ids)
    dev = blocks[0].device
    _check_operands(idx, vals, dev)
    if dev.type == "cpu":
        delta_scatter_shards_reference(blocks, idx, vals, nb, shard_ids=ids)
        return
    if dev.type != "cuda":
        raise ValueError(f"delta_scatter: no kernel for {dev}")
    rows = int(blocks[0].shape[1])
    table: List[Optional[torch.Tensor]] = [None] * (max(ids) + 1)
    for shard, block in zip(ids, blocks):
        table[shard] = block
    _launch(table, rows, 0, int(nb), idx, vals)


# ------------------------------------------------------ plain versions


def delta_scatter_reference(block: torch.Tensor, idx: torch.Tensor,
                            vals: torch.Tensor, row0: int = 0) -> None:
    """The plain PyTorch version of K2 on one block, in place on any
    device."""
    local = idx.long() - row0
    ok = (local >= 0) & (local < block.shape[1])
    block[:, local[ok]] = vals[:, ok]


def delta_scatter_shards_reference(
        blocks: Sequence[torch.Tensor], idx: torch.Tensor,
        vals: torch.Tensor, nb: int, *,
        shard_ids: Optional[Sequence[int]] = None) -> None:
    """The plain PyTorch version of :func:`delta_scatter_shards`: the
    loop of :func:`delta_scatter_reference` with ``row0 = shard * rows``,
    in place on any device."""
    ids = range(len(blocks)) if shard_ids is None else shard_ids
    for shard, block in zip(ids, blocks):
        delta_scatter_reference(block, idx, vals, int(shard) * block.shape[1])
