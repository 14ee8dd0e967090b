"""The benchmark of the PyTorch/CUDA port (``tpu_cc_manager_torch``): the
fleet controller's scans and plan staleness under a rolling CC-mode
change, and the rollout preflight, at published cluster sizes. Imports
nothing of the JAX package. Run ``python3 -m portbench --help``."""
