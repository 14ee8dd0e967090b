"""K5, the device backend's readiness probe.

Replaces ``tpu_cc_manager/device/jaxdev.py::probe_device``'s on-chip
computation (jaxdev.py:274-278: float32 1.0 put on the chip, plus 1.0,
blocked on) with the CUDA kernel in ``csrc/probe.cu``: ``x + 1.0`` in
float32, out of place, on the tensor's own device and on PyTorch's
current stream there. :meth:`CudaBackend.probe_device
<tpu_cc_manager_torch.device.cudadev.CudaBackend.probe_device>` runs it
on a one-element tensor and reads the result back.

Bound on an H100: launch overhead. The probe moves 8 bytes; the launch
and the read-back cost microseconds. Times on the card: PERF.md.

:func:`probe_add_one` launches the kernel for CUDA tensors and runs the
plain PyTorch version (:func:`probe_add_one_reference`) for CPU tensors;
any other device raises. A kernel that fails to build or to launch
raises too: nothing falls back to the plain version.
"""

from __future__ import annotations

import torch

from tpu_cc_manager_torch.kernels import LAUNCHES, _build


def probe_add_one(x: torch.Tensor) -> torch.Tensor:
    """``x + 1.0`` as a new float32 tensor of ``x``'s shape. Launches K5
    for a CUDA tensor, runs :func:`probe_add_one_reference` for a CPU
    tensor."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            "probe_add_one: x must be a contiguous float32 tensor, got "
            f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return probe_add_one_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"probe_add_one: no kernel for {x.device}")
    y = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.tcc_probe_add_one(
            x.data_ptr(), y.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "probe_add_one launch")
    LAUNCHES["probe_add_one"] += 1
    return y


def probe_add_one_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K5, on any device."""
    return x + 1.0
