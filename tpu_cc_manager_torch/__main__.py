"""CLI entrypoint: ``python -m tpu_cc_manager_torch``.

The subcommands the port has, as the reference's
``tpu_cc_manager/__main__.py`` runs them:

- no subcommand: the long-lived node agent (see
  tpu_cc_manager_torch.agent): watches the node's ``cc.mode`` label,
  drains, flips every card through the device layer (``cuda`` by
  default, K5 probing each card after its reset) and publishes the
  state label, evidence and the doctor's verdict;
- ``set-cc-mode -m <mode>``: one-shot engine invocation, with the
  slice-coherent quorum path when ``SLICE_COORDINATION`` is set, the
  evidence publication, and the failed state label on every error path;
- ``get-cc-mode``: print per-device modes as JSON;
- ``probe-devices``: print the device inventory as JSON; ``--backend
  cuda`` (default) asks the live CUDA runtime, ``--backend fake`` the
  in-memory fake;
- ``fleet-controller``: the long-running read-only fleet audit service
  (planner scans on the GPU served as /metrics + /report — see
  tpu_cc_manager_torch.fleet); ``--once`` runs one scan, prints the
  report and exits non-zero when the audit found problems;
- ``doctor``: node-local trust-surface diagnostic — statefile, gate,
  holders, labels, evidence cross-checked in one JSON report (see
  tpu_cc_manager_torch.doctor);
- ``webhook``: admission webhook steering requires-cc pods onto
  verified nodes and rejecting contradictory specs (see
  tpu_cc_manager_torch.webhook);
- ``rollout -m <mode>``: operator-side rolling mode change across the
  pool (see tpu_cc_manager_torch.rollout), its preflight planned on the
  GPU; ``--dry-run`` prints the plan, ``--resume`` continues the durable
  record of an interrupted rollout;
- ``policy-controller``: declarative TPUCCPolicy reconciler driving
  bounded rollouts toward the modes the cluster's policy objects declare
  (see tpu_cc_manager_torch.policy), its pool scans planned on the GPU;
  ``--once`` runs one pass, prints the report and exits non-zero when a
  policy is unhealthy or the CRD is missing;
- ``simlab run|validate|propgen``: the fleet-scale scenario lab (see
  tpu_cc_manager_torch.simlab): live replica agents over fake devices
  behind a wire-level fake API server, their fleet, policy and shard
  controllers planning on the GPU; ``validate`` checks scenario files,
  ``propgen`` generates, runs and shrinks seeded lifecycle episodes.
"""

from __future__ import annotations

import json
import logging
import os
import sys

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.agent import CCManagerAgent
from tpu_cc_manager_torch.config import parse_config
from tpu_cc_manager_torch.device.base import DeviceError
from tpu_cc_manager_torch.drain import build_drainer, set_cc_mode_state_label
from tpu_cc_manager_torch.engine import FatalModeError, ModeEngine, NullDrainer
from tpu_cc_manager_torch.k8s.client import (
    ApiException, HttpKubeClient, KubeConfig,
)
from tpu_cc_manager_torch.obs import setup_logging

log = logging.getLogger("tpu-cc-manager")


def _kube_client(cfg):
    config = KubeConfig.load(cfg.kubeconfig)
    if os.environ.get("TPU_CC_KUBE_AIO", "").lower() in ("1", "true",
                                                         "yes"):
        # the asyncio I/O core: all of this process's node reads,
        # writes and watches multiplex one event loop's pipelined
        # connection pool behind a sync façade. Opt-in: exec-credential
        # auth flows are not implemented there and stay on HttpKubeClient
        from tpu_cc_manager_torch.k8s.aio_bridge import SyncKubeFacade

        return SyncKubeFacade(config)
    return HttpKubeClient(config)


def _leader_elector(kube, lease_name: str):
    """LeaderElector for a controller, when TPU_CC_LEADER_ELECT=true
    (manifests set it; single-replica/dev runs skip election). Identity
    is the pod name (downward API) so `kubectl get lease` names the
    actual holder pod."""
    from tpu_cc_manager_torch.config import _env_bool

    if not _env_bool("TPU_CC_LEADER_ELECT", False):
        return None
    import socket

    from tpu_cc_manager_torch.leader import LeaderElector

    identity = (
        os.environ.get("POD_NAME")
        or f"{socket.gethostname()}-{os.getpid()}"
    )
    if isinstance(kube, HttpKubeClient):
        # the elector gets its OWN unlimited client: lease renewals
        # must never queue behind flow-controlled scan traffic (a renew
        # delayed past the lease duration self-demotes the leader)
        kube = HttpKubeClient(kube.config, qps=0)
    return LeaderElector(
        kube,
        name=lease_name,
        identity=identity,
        namespace=os.environ.get("OPERATOR_NAMESPACE", "tpu-system"),
    )


def _stop_on_sigterm(stop_fn) -> None:
    """Make SIGTERM (the kubelet's pod-stop signal) a clean shutdown for
    long-running commands. The stop runs on a helper thread: a handler
    calling it inline could re-enter a lock the interrupted main thread
    already holds."""
    import signal
    import threading

    def handler(signum, frame):
        threading.Thread(
            target=stop_fn, daemon=True, name="sigterm-stop"
        ).start()

    try:
        signal.signal(signal.SIGTERM, handler)
    except ValueError:
        pass  # not the main thread (embedded use): skip


def _fleet_controller(cfg, args) -> int:
    """``fleet-controller``, as the reference runs it: the planner's
    device is the port's (``cuda:0`` unless ``TPU_CC_TORCH_DEVICE`` asks
    for another), its mesh ``TPU_CC_PLANNER_MESH``'s."""
    from tpu_cc_manager_torch.fleet import FleetController

    # production default: build and launch the planner's kernels at
    # start; --once audits and in-process embedders skip it, and
    # TPU_CC_PLANNER_WARMUP=0 opts a long-running controller out
    if not args.once:
        os.environ.setdefault("TPU_CC_PLANNER_WARMUP", "1")
    try:
        kube = _kube_client(cfg)
        controller = FleetController(
            kube,
            selector=args.selector,
            interval_s=args.interval,
            port=args.port,
            leader_elector=_leader_elector(kube, "tpu-cc-fleet-controller"),
        )
        if args.once:
            # cron/CI audit: one scan, report on stdout (problems
            # inside it), exit code says whether an operator must look
            report = controller.scan_once()
            problems = report["problems"]
            print(json.dumps(report, indent=2, sort_keys=True))
            if problems:
                log.error("fleet audit found problems: %s", problems)
            return 1 if problems else 0
        _stop_on_sigterm(controller.stop)
        # OSError belongs inside the guard too: RouteServer binds
        # lazily in run(), so a busy --port surfaces here
        return controller.run()
    except (ValueError, OSError, ApiException) as e:
        log.error("fleet-controller refused: %s", e)
        return 1


def _rollout(cfg, args) -> int:
    """``rollout``, as the reference runs it: the arguments are checked
    before any API traffic, a ``NodeInformer`` feeds the group judge
    (dry runs never judge and skip it), and the preflight plans on the
    port's planner device (``cuda:0`` unless ``TPU_CC_TORCH_DEVICE``
    asks for another)."""
    from tpu_cc_manager_torch.modes import InvalidModeError, parse_mode
    from tpu_cc_manager_torch.rollout import Rollout, RolloutError

    # argument validation BEFORE any API traffic: a usage error must not
    # cost a fleet-wide informer prime
    if args.resume:
        if args.mode:
            log.error("--resume takes the mode from the durable "
                      "record; do not pass --mode")
            return 1
        if (args.max_unavailable != 1 or args.failure_budget != 0
                or args.canary != 0):
            log.error("--resume takes the window, budget, and "
                      "canary from the durable record; do not "
                      "pass --max-unavailable/--failure-budget/"
                      "--canary")
            return 1
    elif not args.mode:
        log.error("rollout requires -m/--mode (or --resume)")
        return 1
    else:
        try:
            parse_mode(args.mode)
        except InvalidModeError as e:
            log.error("rollout refused: %s", e)
            return 1
    informer = None
    kube = _kube_client(cfg)
    if not args.dry_run:
        # the judge's event feed: one LIST-then-WATCH informer, so that
        # steady-state group judging reads local memory instead of
        # re-LISTing the pool every poll tick
        from tpu_cc_manager_torch.watch import NodeInformer

        try:
            informer = NodeInformer(kube, name="rollout")
            informer.prime()
            informer.start()
        except Exception as e:
            log.warning("node informer unavailable (%s); judging "
                        "on the poll interval", e)
            informer = None
    try:
        if args.resume:
            rollout = Rollout.resume(
                kube,
                selector=args.selector,
                group_timeout_s=args.group_timeout,
                dry_run=args.dry_run,
                verify_evidence=not args.no_verify_evidence,
                informer=informer,
            )
        else:
            rollout = Rollout(
                kube,
                args.mode,
                selector=args.selector or L.TPU_ACCELERATOR_LABEL,
                max_unavailable=args.max_unavailable,
                failure_budget=args.failure_budget,
                canary=args.canary,
                group_timeout_s=args.group_timeout,
                force=args.force,
                dry_run=args.dry_run,
                verify_evidence=not args.no_verify_evidence,
                informer=informer,
            )
        report = rollout.run()
    except (InvalidModeError, RolloutError) as e:
        log.error("rollout refused: %s", e)
        return 1
    finally:
        if informer is not None:
            informer.stop()
    print(report.to_json())
    return 0 if report.ok else 1


def _policy_controller(cfg, args) -> int:
    """``policy-controller``, as the reference runs it: its pool scans
    plan on the port's planner device (``cuda:0`` unless
    ``TPU_CC_TORCH_DEVICE`` asks for another)."""
    from tpu_cc_manager_torch.policy import PolicyController

    # same production default as fleet-controller: build and launch the
    # planner's kernels at start
    os.environ.setdefault("TPU_CC_PLANNER_WARMUP", "1")
    try:
        kube = _kube_client(cfg)
        controller = PolicyController(
            kube,
            interval_s=args.interval,
            port=args.port,
            verify_evidence=not args.no_verify_evidence,
            leader_elector=_leader_elector(kube, "tpu-cc-policy-controller"),
        )
        if args.once:
            # cron/CI mode: one pass, report on stdout (the unhealthy
            # policies inside it), exit code says whether every policy
            # is in a healthy phase
            report = controller.scan_once()
            bad = report["unhealthy_policies"]
            print(json.dumps(report, indent=2, sort_keys=True))
            if report.get("crd_missing"):
                # a one-shot has no next tick: a green exit against a
                # cluster where nothing can be reconciled would lie to
                # the pipeline
                log.error("TPUCCPolicy CRD not installed (or wrong "
                          "cluster): nothing was reconciled")
                return 1
            if bad:
                log.error("unhealthy policies: %s", bad)
            return 1 if bad else 0
        _stop_on_sigterm(controller.stop)
        return controller.run()
    except (ValueError, OSError, ApiException) as e:
        log.error("policy-controller refused: %s", e)
        return 1


def main(argv=None) -> int:
    cfg, args = parse_config(argv)
    setup_logging(cfg.debug, fmt=cfg.log_format)

    if args.command == "fleet-controller":
        return _fleet_controller(cfg, args)

    if args.command == "rollout":
        return _rollout(cfg, args)

    if args.command == "policy-controller":
        return _policy_controller(cfg, args)

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

    if args.command == "get-cc-mode":
        engine = ModeEngine(set_state_label=lambda v: None,
                            drainer=NullDrainer(), evict_components=False)
        try:
            modes = engine.get_modes()
        except DeviceError as e:
            print(f"tpu-cc-manager: get-cc-mode failed: {e}",
                  file=sys.stderr)
            return 1
        print(json.dumps(modes, indent=2, sort_keys=True))
        return 0

    if args.command == "doctor":
        from tpu_cc_manager_torch.doctor import main_from_args

        return main_from_args(cfg, args)

    if args.command == "simlab":
        from tpu_cc_manager_torch.simlab import main_from_args

        return main_from_args(args)

    if args.command == "webhook":
        from tpu_cc_manager_torch.webhook import AdmissionServer

        try:
            server = AdmissionServer(
                args.port, cert_file=args.cert, key_file=args.key,
            )
        except (ValueError, OSError) as e:
            log.error("webhook refused: %s", e)
            return 1
        _stop_on_sigterm(server.stop)
        return server.serve_forever()

    if args.command == "set-cc-mode":
        return _set_cc_mode(cfg, args)

    # long-lived agent
    kube = _kube_client(cfg)
    slice_coordinator = None
    if cfg.slice_coordination:
        from tpu_cc_manager_torch.slice_coord import SliceCoordinator

        slice_coordinator = SliceCoordinator(
            kube, cfg.node_name,
            commit_timeout_s=cfg.slice_commit_timeout_s,
        )
    agent = CCManagerAgent(kube, cfg, slice_coordinator=slice_coordinator)
    _stop_on_sigterm(agent.shutdown)
    # the black box survives the kill: the SIGTERM dump runs first,
    # then chains into the clean-shutdown handler installed above
    from tpu_cc_manager_torch.flightrec import install_sigterm_dump

    install_sigterm_dump(agent.flightrec)
    return agent.run()


def _publish_failed(kube, node_name: str) -> None:
    """Best-effort ``cc.mode.state=failed``: the state label is the
    cluster's only machine-readable outcome for a one-shot run, and the
    label write itself may be what failed."""
    from tpu_cc_manager_torch.modes import STATE_FAILED

    try:
        set_cc_mode_state_label(kube, node_name, STATE_FAILED)
    except Exception as pub_err:
        log.error("could not publish cc.mode.state=failed: %s", pub_err)


def _set_cc_mode(cfg, args) -> int:
    """``set-cc-mode -m <mode>``, as the reference runs it: one engine
    invocation (through the slice quorum when ``SLICE_COORDINATION`` is
    set), evidence on success, a reconcile Event either way, and the
    failed state label on every error path."""
    import time
    import uuid

    from tpu_cc_manager_torch.drain import (
        NodeFlipTaint, build_reconcile_event, post_event_best_effort,
    )
    from tpu_cc_manager_torch.modes import InvalidModeError
    from tpu_cc_manager_torch.slice_coord import (
        SliceAbortError, SliceCoordinator,
    )

    kube = _kube_client(cfg)
    engine = ModeEngine(
        set_state_label=lambda v: set_cc_mode_state_label(
            kube, cfg.node_name, v
        ),
        drainer=build_drainer(kube, cfg),
        evict_components=cfg.evict_components and cfg.drain_strategy != "none",
        flip_taint=NodeFlipTaint(kube, cfg.node_name),
    )

    def _post_event(outcome: str, dur: float) -> None:
        if not cfg.emit_events:
            return
        event = build_reconcile_event(
            cfg.node_name, args.mode, outcome, dur,
            name=f"{cfg.node_name}.cc-oneshot.{uuid.uuid4().hex[:8]}",
        )
        if event is not None:
            post_event_best_effort(kube, event)

    coordinator = None
    if cfg.slice_coordination:
        coordinator = SliceCoordinator(
            kube, cfg.node_name,
            commit_timeout_s=cfg.slice_commit_timeout_s,
        )

    t0 = time.monotonic()
    try:
        if coordinator is not None:
            try:
                coordinator.start()  # heartbeat, like the agent
                ok = coordinator.apply_slice_coherent(args.mode, engine)
            finally:
                coordinator.stop()
        else:
            ok = engine.set_mode(args.mode)
        if ok and cfg.emit_evidence:
            # the same per-flip evidence the long-lived agent publishes
            from tpu_cc_manager_torch.evidence import publish_evidence

            publish_evidence(kube, cfg.node_name)
        _post_event("success" if ok else "failure", time.monotonic() - t0)
        return 0 if ok else 1
    except InvalidModeError as e:
        # a typo'd mode is a clean rejection (CCModeInvalid), not a
        # flip failure
        log.error("rejecting desired mode: %s", e)
        _publish_failed(kube, cfg.node_name)
        _post_event("invalid", time.monotonic() - t0)
        return 1
    except SliceAbortError as e:
        # the slice never agreed; local devices untouched
        log.error("slice coordination aborted: %s", e)
        _publish_failed(kube, cfg.node_name)
        _post_event("slice_abort", time.monotonic() - t0)
        return 1
    except FatalModeError as e:
        log.error("fatal: %s", e)
        _post_event("fatal", time.monotonic() - t0)
        return 1
    except Exception:
        # never exit without publishing failure; with no CUDA device
        # and no CPU request the enumeration error lands here
        log.exception("set-cc-mode failed unexpectedly")
        _publish_failed(kube, cfg.node_name)
        _post_event("error", time.monotonic() - t0)
        return 1


if __name__ == "__main__":
    sys.exit(main())
