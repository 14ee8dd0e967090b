"""K2, the incremental tick's delta scatter.

Replaces ``tpu_cc_manager/plan.py::_scatter_fn``'s scatter
(plan.py:1075-1094), a jitted XLA program over donated buffers, with the
CUDA kernel in ``csrc/delta_scatter.cu``: it writes up to ``kb`` changed
rows of all 8 columns into the session's resident ``int32[8, nb]`` block
in place. Index ``nb`` is padding; any index outside ``[0, nb)`` changes
nothing. The caller guarantees the indices are unique.

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
                  vals: torch.Tensor) -> None:
    """``block[c, idx[j]] = vals[c, j]`` for every column ``c`` and every
    ``j`` with ``0 <= idx[j] < nb``, in place. Launches K2 for CUDA
    tensors, runs :func:`delta_scatter_reference` for CPU tensors."""
    _check(block, idx, vals)
    if block.device.type == "cpu":
        delta_scatter_reference(block, idx, vals)
        return
    if block.device.type != "cuda":
        raise ValueError(f"delta_scatter: no kernel for {block.device}")
    lib = _build.library()
    with torch.cuda.device(block.device):
        rc = lib.tcc_delta_scatter(
            block.data_ptr(), int(block.shape[1]), idx.data_ptr(),
            vals.data_ptr(), int(idx.shape[0]),
            torch.cuda.current_stream(block.device).cuda_stream)
    _build.check(rc, "delta_scatter launch")
    LAUNCHES["delta_scatter"] += 1


def delta_scatter_reference(block: torch.Tensor, idx: torch.Tensor,
                            vals: torch.Tensor) -> None:
    """The plain PyTorch version of K2, in place on any device."""
    ok = (idx >= 0) & (idx < block.shape[1])
    block[:, idx[ok].long()] = vals[:, ok]
