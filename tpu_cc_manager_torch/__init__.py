"""tpu-cc-manager on PyTorch and CUDA: the fleet planner on an NVIDIA H100.

A port of the JAX package ``tpu_cc_manager`` that stands beside it. Module
names mirror the JAX package so each counterpart is easy to find:

- ``plan``: the fleet planner (encoding, tick session, reports, CLI),
  whose device side runs the hand-written kernels below;
- ``kernels.fleet_tick`` / ``kernels.delta_scatter``: the CUDA kernels'
  wrappers, each with its plain PyTorch version and a launch count;
- ``kernels._build``: compiles ``csrc/*.cu`` with ``nvcc`` for ``sm_90a``
  at first use;
- ``graft_entry``: the single-device compile-check entry;
- ``labels``, ``modes``, ``watch``: the port's own copies of the JAX-free
  vocabulary the planner needs.

The package imports ``torch`` and ``numpy``, never ``jax`` and never the
JAX package. Its entry points run on ``cuda:0`` unless the caller asks for
the CPU (``device="cpu"`` or ``TPU_CC_TORCH_DEVICE=cpu``); with no CUDA
device and no such request they raise.
"""
