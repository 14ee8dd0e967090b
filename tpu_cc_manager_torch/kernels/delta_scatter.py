"""K2, the incremental tick's delta scatter.

Replaces ``tpu_cc_manager/plan.py::_scatter_fn``'s scatter
(plan.py:1075-1094), a jitted XLA program over donated buffers, with the
CUDA kernel in ``csrc/delta_scatter.cu``: it writes up to ``kb`` changed
rows of all 8 columns into the session's resident ``int32[8, nb]`` block
in place. Index ``nb`` is padding; any index outside ``[0, nb)`` changes
nothing. The caller guarantees the indices are unique. On a mesh each
shard's block holds the global rows ``[row0, row0 + rows)`` and takes
only those indices; unlike the reference's shard, which clips a foreign
index onto its last row (plan.py:1083-1093), every other index is
dropped, so no shard can overwrite a real update.

Bound on an H100: launch overhead. Every index is read (4 bytes per
slot) and each live slot's 8 values are read and written (64 bytes):
about 0.7 MB at kb = 16,384 with 10,000 live rows, which the card's
memory rate covers in well under a microsecond. Times on the card:
PERF.md.

:func:`delta_scatter` launches the kernel for CUDA tensors and runs the
plain PyTorch version (:func:`delta_scatter_reference`) for CPU tensors;
any other device raises.
"""

from __future__ import annotations

import torch

from tpu_cc_manager_torch.kernels import LAUNCHES, _build

N_COLS = 8


def _check(block: torch.Tensor, idx: torch.Tensor,
           vals: torch.Tensor) -> None:
    if (block.dtype != torch.int32 or block.dim() != 2
            or block.shape[0] != N_COLS or not block.is_contiguous()):
        raise ValueError(
            "delta_scatter: the block must be a contiguous int32 "
            f"[{N_COLS}, nb] tensor, got {block.dtype} {tuple(block.shape)}")
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
    if not block.device == idx.device == vals.device:
        raise ValueError(
            f"delta_scatter: block on {block.device}, idx on {idx.device}, "
            f"vals on {vals.device}")
    if block.shape[1] >= 2 ** 31 or idx.shape[0] * N_COLS >= 2 ** 31:
        raise ValueError("delta_scatter: sizes exceed int32")


def delta_scatter(block: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor, row0: int = 0) -> None:
    """``block[c, idx[j] - row0] = vals[c, j]`` for every column ``c`` and
    every ``j`` with ``row0 <= idx[j] < row0 + rows``, in place (``rows``
    is the block's width; ``row0`` is 0 for an unsharded block). Launches
    K2 for CUDA tensors, runs :func:`delta_scatter_reference` for CPU
    tensors."""
    _check(block, idx, vals)
    row0 = int(row0)
    if not 0 <= row0 < 2 ** 31:
        raise ValueError(f"delta_scatter: row0={row0} is not an int32 >= 0")
    if block.device.type == "cpu":
        delta_scatter_reference(block, idx, vals, row0)
        return
    if block.device.type != "cuda":
        raise ValueError(f"delta_scatter: no kernel for {block.device}")
    lib = _build.library()
    with torch.cuda.device(block.device):
        rc = lib.tcc_delta_scatter(
            block.data_ptr(), int(block.shape[1]), idx.data_ptr(),
            vals.data_ptr(), int(idx.shape[0]), row0,
            torch.cuda.current_stream(block.device).cuda_stream)
    _build.check(rc, "delta_scatter launch")
    LAUNCHES["delta_scatter"] += 1


def delta_scatter_reference(block: torch.Tensor, idx: torch.Tensor,
                            vals: torch.Tensor, row0: int = 0) -> None:
    """The plain PyTorch version of K2, in place on any device."""
    local = idx.long() - row0
    ok = (local >= 0) & (local < block.shape[1])
    block[:, local[ok]] = vals[:, ok]
