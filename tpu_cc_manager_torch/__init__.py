"""tpu-cc-manager on PyTorch and CUDA: the fleet planner and the node's
mode flip on an NVIDIA H100.

A port of the JAX package ``tpu_cc_manager`` that stands beside it. Module
names mirror the JAX package so each counterpart is easy to find:

- ``plan``: the fleet planner (encoding, tick session, reports, CLI),
  whose device side runs the hand-written kernels below;
- ``engine``: the mode engine (validate, plan, stage, reset, wait,
  verify), with ``flipexec`` (the parallel flip pipeline), ``trace``,
  ``flightrec``, ``attest`` and ``identity`` beside it;
- ``device``: the device layer (``base``, ``statefile``, ``native``,
  ``gate``, ``holders``, ``fake``) and ``device.cudadev``, the CUDA
  backend that enumerates the host's CUDA devices and probes each one
  with kernel K5 after a reset;
- ``k8s``: the stdlib API client and the asyncio I/O core the flip path
  overlaps its holder scan on;
- ``config`` and ``__main__``: ``python -m tpu_cc_manager_torch
  probe-devices|get-cc-mode``;
- ``kernels.fleet_tick`` / ``kernels.delta_scatter`` / ``kernels.probe``:
  the CUDA kernels' wrappers, each with its plain PyTorch version and a
  launch count;
- ``kernels._build``: compiles ``csrc/*.cu`` with ``nvcc`` for ``sm_90a``
  at first use;
- ``graft_entry``: the single-device compile-check entry;
- ``labels``, ``modes``, ``watch``: the port's own copies of the JAX-free
  vocabulary the planner and the engine need.

Most JAX-free modules are copies of the reference's, with only the
package name rewritten in their imports; ``tests/test_torch_copies.py``
holds each to its reference.

The package imports ``torch`` and ``numpy``, never ``jax`` and never the
JAX package. Its entry points run on ``cuda:0`` (the device backend on
every CUDA device) unless the caller asks for the CPU (``device="cpu"``
or ``TPU_CC_TORCH_DEVICE=cpu``); with no CUDA device and no such request
they raise or report an error.
"""

__version__ = "0.1.0"
