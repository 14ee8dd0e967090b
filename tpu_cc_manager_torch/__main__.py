"""CLI entrypoint: ``python -m tpu_cc_manager_torch``.

The two subcommands that need no cluster, as the reference's
``tpu_cc_manager/__main__.py`` runs them:

- ``probe-devices``: print the device inventory as JSON; ``--backend
  cuda`` (default) asks the live CUDA runtime, ``--backend fake`` the
  in-memory fake;
- ``get-cc-mode``: print per-device modes as JSON.

Every other subcommand, and the long-lived agent (no subcommand), exits 2
and names the ROADMAP item that ports it: they need the port's k8s layer
and controllers, which come with later slices.
"""

from __future__ import annotations

import json
import logging
import os
import sys

from tpu_cc_manager_torch.config import build_parser, parse_config
from tpu_cc_manager_torch.device.base import DeviceError
from tpu_cc_manager_torch.engine import ModeEngine, NullDrainer

#: subcommand (None = the agent) -> the ROADMAP item that ports it
NOT_PORTED = {
    None: "ROADMAP Queue 1 item 3 (slice 3: the node agent)",
    "set-cc-mode": "ROADMAP Queue 1 item 3 (slice 3: set-cc-mode)",
    "doctor": "ROADMAP Queue 1 item 3 (slice 3: doctor)",
    "rollout": "ROADMAP Queue 1 item 4 (the controllers)",
    "fleet-controller": "ROADMAP Queue 1 item 4 (the controllers)",
    "policy-controller": "ROADMAP Queue 1 item 4 (the controllers)",
    "webhook": "ROADMAP Queue 1 item 5 (entry points and simlab)",
    "simlab": "ROADMAP Queue 1 item 5 (entry points and simlab)",
}


def main(argv=None) -> int:
    command = build_parser().parse_args(argv).command
    if command in NOT_PORTED:
        print(f"tpu-cc-manager (PyTorch port): "
              f"{command or 'the agent'} is not ported yet; "
              f"{NOT_PORTED[command]}", file=sys.stderr)
        return 2
    cfg, args = parse_config(argv)
    logging.basicConfig(
        level=logging.DEBUG if cfg.debug else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
        force=True,
    )

    if args.command == "probe-devices":
        # Device inventory; --backend cuda (default) asks the live CUDA
        # runtime — the hardware-truth surface (reference main.py:258-296
        # queries hardware the same way). Never tracebacks: failures come
        # back as JSON with rc 1.
        from tpu_cc_manager_torch.device import describe_backend
        from tpu_cc_manager_torch.device.base import _default_backend

        # scope the backend override to this call — main() also runs
        # in-process (tests, embedders), where a permanent os.environ
        # mutation would silently re-route every later backend default
        prev = os.environ.get("TPU_CC_DEVICE_BACKEND")
        os.environ["TPU_CC_DEVICE_BACKEND"] = args.backend
        try:
            out = describe_backend(_default_backend(), name=args.backend)
        except Exception as e:
            print(json.dumps(
                {"backend": args.backend, "error": str(e), "devices": []},
                indent=2, sort_keys=True,
            ))
            return 1
        finally:
            if prev is None:
                os.environ.pop("TPU_CC_DEVICE_BACKEND", None)
            else:
                os.environ["TPU_CC_DEVICE_BACKEND"] = prev
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0

    # get-cc-mode
    engine = ModeEngine(set_state_label=lambda v: None, drainer=NullDrainer(),
                        evict_components=False)
    try:
        modes = engine.get_modes()
    except DeviceError as e:
        print(f"tpu-cc-manager: get-cc-mode failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps(modes, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
