"""L1 mode engine — the validate / plan / stage / reset / verify machine.

Pure logic over the L0 device interface and two injected collaborators (a
state-label writer and a drainer), so it is fully unit-testable — the
design SURVEY.md §7.2 step 2 calls for. Semantics cover the reference's
two engines:

- mode validation + routing:                reference main.py:486-510
- CC/ICI mutual exclusion:                  reference main.py:512-583
- mixed-capability bailout:                 reference main.py:208-217
- idempotent fast path:                     reference main.py:227-230,237-256
- per-device stage→reset→wait→verify:       reference main.py:258-311
- ICI (PPCIe-analog) over chips+switches:   reference main.py:369-484
- 0-devices fast success, always-restore
  drained components on failure:            reference scripts/cc-manager.sh:338-340,210-215

One deliberate TPU-first improvement over the reference: instead of
flipping domains sequentially (the reference runs a full
evict→set→reset→restore cycle to turn PPCIe off, then a *second* full
cycle to turn CC on — main.py:534-559), this engine computes the desired
end state of BOTH domains up front, stages every divergent domain on a
device, and performs ONE drain cycle and ONE reset per device. Mode
transitions that cross domains cost one workload disruption instead of
two, and each chip reboots once instead of twice.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from tpu_cc_manager_torch import device as devlayer
from tpu_cc_manager_torch import flightrec
from tpu_cc_manager_torch.device.base import DeviceError, TpuChip
from tpu_cc_manager_torch.device.gate import DeviceGate
from tpu_cc_manager_torch.device.holders import HolderCheck
from tpu_cc_manager_torch.flipexec import (
    FAILED,
    SKIPPED,
    FlipOutcome,
    flip_concurrency as resolve_flip_concurrency,
    flip_concurrency_knob,
    join_overlapped,
    run_flips,
    submit_overlapped,
)
from tpu_cc_manager_torch.modes import CC_MODES, Mode, STATE_FAILED, parse_mode
from tpu_cc_manager_torch.trace import Tracer, get_tracer

log = logging.getLogger("tpu-cc-manager.engine")


class FatalModeError(Exception):
    """Unrecoverable condition: the agent must exit rather than retry.

    The reference hard-exits (sys.exit(1)) when a node mixes CC-capable and
    non-capable devices and a protected mode is requested
    (reference main.py:214-217) — retrying can never succeed and leaving
    the node half-protected is worse than crashing loudly.
    """


class Drainer:
    """L2 collaborator interface; see tpu_cc_manager.drain for real impls."""

    #: did the last evict/reschedule pair WRITE the node object (pause/
    #: restore labels, cordon)? The engine uses this to decide whether
    #: the taint layer's cached node survived the drain. Conservative
    #: default: assume writes.
    wrote_node = True

    #: optional wake source for the drainer's wait loops (ISSUE 14's
    #: wake treatment): a ``threading.Event`` the caller pulses on
    #: watch deltas so a restore/taint/cordon change is noticed on the
    #: event, not the next poll boundary. ``poll_s`` stays the
    #: liveness fallback. None = plain interval polling (one-shot
    #: CLIs, tests).
    wake = None

    def evict(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def reschedule(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class NullDrainer(Drainer):
    """No-op drainer (EVICT_OPERATOR_COMPONENTS=false, reference main.py:94-96)."""

    wrote_node = False

    def evict(self) -> None:
        pass

    def reschedule(self) -> None:
        pass


class FlipTaint:
    """Collaborator interface: mark the node unschedulable-for-new-work
    for the duration of a flip (``tpu.google.com/cc.mode=flipping:
    NoSchedule``), so the *scheduler* — not just the pause labels — knows
    a flip is in progress. See tpu_cc_manager.drain.NodeFlipTaint for the
    real k8s implementation; this default is a no-op (one-shot CLIs
    without cluster access, unit tests)."""

    def set(self) -> None:
        pass

    def clear(self) -> None:
        pass

    def clear_and_publish_state(self, state: str) -> bool:
        """Clear the taint AND publish ``cc.mode.state=state`` in ONE
        node write where the implementation can (NodeFlipTaint's CAS
        replace already holds the whole node object — folding the label
        in halves the post-flip API round trips, the reconcile hot
        path's perf budget). Returns True when the label was published;
        False means the caller must publish it itself."""
        self.clear()
        return False


#: One unit of planned device work: the device and the per-domain targets
#: it diverges on ({"cc": "on"} / {"ici": "off"} / both).
PlanItem = Tuple[TpuChip, Dict[str, str]]

#: Per-device mode snapshot: path -> {"cc": ..., "ici": ...} (domains the
#: device supports). Taken ONCE per reconcile and threaded through
#: planning, the converged-subset gate reassert, and the post-verify
#: gate fallback — the idempotent fast path costs one query per domain
#: per device instead of two.
ModeSnapshot = Dict[str, Dict[str, str]]


class ModeEngine:
    def __init__(
        self,
        *,
        set_state_label: Callable[[str], None],
        drainer: Optional[Drainer] = None,
        evict_components: bool = True,
        boot_timeout_s: float = 300.0,
        backend=None,
        tracer: Optional[Tracer] = None,
        gate: Optional[DeviceGate] = None,
        flip_taint: Optional[FlipTaint] = None,
        holder_check: Optional[HolderCheck] = None,
        notify_state_label: Optional[Callable[[str], None]] = None,
        flip_concurrency: Optional[int] = None,
        persistent_flip_pool: bool = False,
        recorder=None,
        attestor=None,
    ):
        self._set_state_label = set_state_label
        #: observation-only hook invoked when the state label's WIRE
        #: write rode the taint-clear replace (clear_and_publish_state)
        #: instead of going through set_state_label — metric gauges and
        #: similar observers must still see every transition
        self._notify_state_label = notify_state_label
        self._drainer = drainer or NullDrainer()
        self._evict_components = evict_components
        self._boot_timeout_s = boot_timeout_s
        #: device backend override; None = the process-wide backend. The
        #: multi-node simulation injects one backend per simulated host.
        self._backend = backend
        self._tracer = tracer or get_tracer()
        #: workload-visible device-node gating (TPU_CC_DEVICE_GATING)
        self._gate = gate or DeviceGate()
        self._flip_taint = flip_taint or FlipTaint()
        #: exclusive-hold guarantee before commit (TPU_CC_HOLDER_CHECK)
        self._holder_check = holder_check or HolderCheck()
        #: per-device flip parallelism; None -> TPU_CC_FLIP_CONCURRENCY
        #: env (default min(4, plan size)); 1 -> the serial loop exactly.
        #: See flipexec.py and docs/engine.md for the contract.
        self._flip_concurrency = flip_concurrency
        #: when set, parallel flips reuse ONE lazily-created worker pool
        #: across reconciles (sized to the unclamped concurrency knob)
        #: instead of spawning/joining threads every flip — the
        #: long-lived agent opts in and calls close(); one-shot CLIs,
        #: tests, and simlab replicas keep the per-call pool so they
        #: never strand idle threads (ISSUE 6 flip-path I/O)
        self._persistent_flip_pool = persistent_flip_pool
        self._flip_pool = None
        self._flip_pool_lock = threading.Lock()
        #: per-engine measured-history sink (an attest.FakeTpm-shaped
        #: object with .extend); None = the process-global provider
        #: (attest.note_mode_applied). simlab injects one per replica
        #: so a single process carries a fleet of independent PCRs.
        self._attestor = attestor
        #: flight recorder whose host-contention sampler brackets every
        #: device flip (flightrec.py, ISSUE 8 — the sensor ROADMAP item
        #: 1 needs: was the slow real-chip flip the chip, or the
        #: host?); None = the process-wide recorder at flip time
        self._recorder = recorder

    def _flip_recorder(self):
        """The injected recorder, or the process-wide one — resolved
        per flip (not cached) so flightrec.set_recorder swaps apply."""
        return self._recorder or flightrec.get_recorder()

    # ---------------------------------------------------------- lifecycle
    def _flip_executor(self):
        """The persistent flip worker pool (lazily created, sized to the
        unclamped concurrency knob — which upper-bounds every per-plan
        cap, so a pool-run plan never exceeds its requested
        concurrency). None when persistence is off."""
        if not self._persistent_flip_pool:
            return None
        from concurrent.futures import ThreadPoolExecutor

        with self._flip_pool_lock:
            if self._flip_pool is None:
                # ccaudit: allow-blocking-under-lock(lazy singleton creation: the executor constructor only registers state — worker threads spawn on submit(), which happens outside this lock)
                self._flip_pool = ThreadPoolExecutor(
                    max_workers=flip_concurrency_knob(
                        self._flip_concurrency
                    ),
                    thread_name_prefix="cc-flip",
                )
            return self._flip_pool

    def close(self) -> None:
        """Release the persistent flip worker pool (no-op otherwise).
        The owning agent calls this on shutdown; a closed engine lazily
        re-creates the pool if reused."""
        with self._flip_pool_lock:
            pool, self._flip_pool = self._flip_pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    # ------------------------------------------------------------- queries
    def get_modes(self) -> dict:
        """Per-device current modes (get-cc-mode analog,
        reference scripts/cc-manager.sh:407-450)."""
        out = {}
        for dev in self._all_devices():
            entry = {}
            if dev.is_cc_query_supported:
                entry["cc"] = dev.query_cc_mode()
            if dev.is_ici_query_supported:
                entry["ici"] = dev.query_ici_mode()
            out[dev.path] = entry
        return out

    def reassert_gate(self) -> None:
        """Re-apply the workload-visible gate for every device's CURRENT
        effective mode. Reconciles only run on label events and repairs;
        this lets the agent's idle tick heal perms drift (someone chmods
        /dev/accel* back open) without waiting for the next flip.
        Best-effort and local-only — never touches cluster state.

        Devices sitting at the flip-lock perms are SKIPPED: a failed
        flip leaves its device locked on purpose (fail-secure,
        device/gate.py) and only a successful reconcile may reopen it —
        drift toward locked is the safe direction either way."""
        from tpu_cc_manager_torch.device.gate import FLIP_LOCK_PERMS

        if not self._gate.enabled:
            # nothing to heal, and the per-chip mode queries below would
            # be pure wasted device I/O on every idle tick
            return
        try:
            devices = self._all_devices()
        except DeviceError:
            return
        for dev in devices:
            if not dev.is_cc_query_supported or dev.is_ici_switch():
                continue
            if self._gate.current_perms(dev.path) == FLIP_LOCK_PERMS:
                continue  # fail-secure lock: never reopened by drift-heal
            try:
                self._gate.apply_mode(dev.path, dev.query_cc_mode())
            except DeviceError:
                pass

    # ------------------------------------------------------------ top level
    def set_mode(self, raw_mode: str) -> bool:
        """Validate, plan, apply. Returns True on success. Raises
        FatalModeError on unrecoverable states and InvalidModeError on bad
        input (reference main.py:486-510)."""
        mode = parse_mode(raw_mode)
        log.info("applying desired mode %r", mode.value)

        # desired end state of both domains — mutual exclusion by
        # construction (reference main.py:512-583)
        desired_cc = mode.value if mode in CC_MODES else Mode.OFF.value
        desired_ici = Mode.ON.value if mode is Mode.ICI else Mode.OFF.value

        with self._tracer.span("enumerate"):
            devices = self._all_devices()
        self._check_capability(devices, mode)

        with self._tracer.span("plan", mode=mode.value) as plan_span:
            snapshot = self._snapshot_modes(devices)
            plan = self._plan(devices, desired_cc, desired_ici, snapshot)
            plan_span.attrs["devices"] = len(devices)
            plan_span.attrs["divergent"] = len(plan)
        # re-assert the workload-visible gate on every device that is
        # ALREADY in its desired mode (the whole node on the idempotent
        # fast path, the converged subset on a partial flip): an agent
        # restart after someone reset /dev perms must reconverge the
        # node-local consequence, not just the bookkeeping. In-plan
        # devices are gated inside _apply_plan. The snapshot taken for
        # planning answers the "what mode is it in?" question here too —
        # no second round of device queries for the converged subset.
        in_plan = {dev.path for dev, _ in plan}
        for dev in devices:
            if dev.path not in in_plan and dev.is_cc_query_supported:
                self._gate.apply_mode(dev.path, snapshot[dev.path]["cc"])

        if not plan:
            n = len(devices)
            if n:
                log.info("all %d device(s) already in mode %r", n, mode.value)
                self._set_state_label(mode.value)
            else:
                # no devices at all -> success, nothing to do
                # (reference scripts/cc-manager.sh:338-340)
                log.info("no TPU devices on this node; nothing to do")
            return True

        log.info(
            "mode plan: %s",
            [(d.path, changes) for d, changes in plan],
        )
        # resolve the concurrency knob BEFORE the taint/evict cycle: a
        # typo'd TPU_CC_FLIP_CONCURRENCY must fail here (the agent still
        # publishes cc.mode.state=failed), not churn workloads through a
        # drain/reschedule round trip on every reconcile first
        cap = resolve_flip_concurrency(
            sum(1 for d, _ in plan if not d.is_ici_switch()),
            self._flip_concurrency,
        )
        ok = self._drain_wrapped(
            lambda: self._apply_plan(plan, snapshot, cap), mode.value
        )
        if ok:
            # measured flip history (tpu_cc_manager.attest): only REAL
            # transitions extend the PCR — the idempotent fast path
            # returned above, so the log records flips, not reconciles.
            # Best-effort either way; a TPM hiccup must not fail a
            # flip that already landed.
            if self._attestor is not None:
                try:
                    self._attestor.extend(f"mode:{mode.value}")
                except Exception:
                    log.warning(
                        "attestation extend failed; measured flip "
                        "history will lag", exc_info=True,
                    )
            else:
                from tpu_cc_manager_torch.attest import note_mode_applied

                note_mode_applied(mode.value)
        return ok

    # ------------------------------------------------------------- planning
    def _all_devices(self) -> List[TpuChip]:
        backend = self._backend or devlayer.get_backend()
        chips, err = backend.find_tpus()
        if err:
            raise DeviceError(f"device enumeration failed: {err}")
        switches = [c for c in backend.find_ici_switches()
                    if c.path not in {x.path for x in chips}]
        return list(chips) + switches

    def _check_capability(self, devices: Sequence[TpuChip], mode: Mode) -> None:
        """Mixed-capability bailout (reference main.py:208-217): if any
        non-switch chip cannot do CC and a protected mode is requested,
        abort the agent — never leave a node partially protected."""
        if mode is Mode.OFF:
            return
        incapable = [
            c.path
            for c in devices
            if not c.is_ici_switch() and not c.is_cc_query_supported
        ]
        if incapable:
            raise FatalModeError(
                f"node mixes CC-capable and non-capable TPUs ({incapable}); "
                f"refusing mode {mode.value!r} on a mixed node"
            )

    def _snapshot_modes(self, devices: Sequence[TpuChip]) -> ModeSnapshot:
        """One mode query per supported domain per device, taken once per
        reconcile. Planning, the converged-subset gate reassert, and the
        post-verify gate fallback all read this snapshot instead of
        re-querying — half the device I/O on the idempotent fast path."""
        snap: ModeSnapshot = {}
        for dev in devices:
            entry: Dict[str, str] = {}
            if dev.is_cc_query_supported:
                entry["cc"] = dev.query_cc_mode()
            if dev.is_ici_query_supported:
                entry["ici"] = dev.query_ici_mode()
            snap[dev.path] = entry
        return snap

    def _plan(
        self,
        devices: Sequence[TpuChip],
        desired_cc: str,
        desired_ici: str,
        snapshot: ModeSnapshot,
    ) -> List[PlanItem]:
        """Per-device divergence between current and desired domain modes.
        Empty plan == the idempotent fast path (reference main.py:227-230)."""
        plan: List[PlanItem] = []
        for dev in devices:
            current = snapshot[dev.path]
            changes: Dict[str, str] = {}
            if "cc" in current and current["cc"] != desired_cc:
                changes["cc"] = desired_cc
            if "ici" in current and current["ici"] != desired_ici:
                changes["ici"] = desired_ici
            if changes:
                plan.append((dev, changes))
        return plan

    # ------------------------------------------------------------ applying
    def _drain_wrapped(self, apply: Callable[[], bool], state_on_success: str) -> bool:
        """Evict around the flip; ALWAYS reschedule, even when evict or the
        flip itself failed (reference scripts/cc-manager.sh:210-215)."""
        ok = False
        # taint first: new TPU pods must stop landing on a node whose
        # devices are about to be gated. Best-effort — a node that can't
        # be tainted (RBAC gap) still gets the drain + gate protections.
        try:
            with self._tracer.span("taint_set"):
                self._flip_taint.set()
        except Exception:
            log.warning("failed to set flip taint; continuing", exc_info=True)
        try:
            if self._evict_components:
                with self._tracer.span("evict"):
                    self._drainer.evict()
            ok = apply()
        except DeviceError as e:
            log.error("mode flip failed: %s", e)
            ok = False
        except Exception:
            # Unexpected (non-device) failure mid-flip: still publish
            # cc.mode.state=failed below — the reference labels failed on
            # every failure path (main.py:300-307); without this a one-shot
            # set-cc-mode could exit leaving the stale previous state label.
            log.exception("mode flip failed unexpectedly")
            ok = False
        finally:
            if self._evict_components:
                try:
                    with self._tracer.span("reschedule"):
                        self._drainer.reschedule()
                except Exception:
                    log.exception("failed to reschedule drained components")
                # pause/restore patched node labels: any node object the
                # taint layer cached from its own set() is stale now —
                # but only when the drainer actually WROTE (a node with
                # no components deployed keeps the seed, and the clear
                # stays a single round trip)
                if getattr(self._drainer, "wrote_node", True):
                    invalidate = getattr(
                        self._flip_taint, "invalidate_cache", None
                    )
                    if invalidate is not None:
                        invalidate()
            state = state_on_success if ok else STATE_FAILED
            published = False
            try:
                # one node write clears the taint AND publishes the
                # state label when the taint impl supports it — the
                # separate clear-then-patch pair was two of the five
                # API round trips on the flip hot path
                with self._tracer.span("taint_clear"):
                    published = (
                        self._flip_taint.clear_and_publish_state(state)
                    )
            except Exception:
                log.warning("failed to clear flip taint", exc_info=True)
        if published:
            # the wire write rode the taint-clear replace; observers
            # wired through the callback (agent metrics' current-mode
            # gauge) still need to hear about the transition
            if self._notify_state_label is not None:
                self._notify_state_label(state)
        else:
            with self._tracer.span("state_label"):
                self._set_state_label(state)
        return ok

    def _apply_plan(
        self, plan: Sequence[PlanItem], snapshot: ModeSnapshot, cap: int
    ) -> bool:
        """Per-device flip pipeline (reference main.py:258-311, made
        concurrent): every chip's lock-gate → stage → holder-check →
        reset → wait_ready → verify → re-gate sequence runs through the
        bounded flip executor (flipexec.py; TPU_CC_FLIP_CONCURRENCY,
        default min(4, chips in plan), 1 = the historical serial loop).
        Fail-secure under concurrency: any device failure fails the
        whole flip, the failing device stays at FLIP_LOCK_PERMS,
        in-flight siblings run their own sequence to completion (and
        re-open on their own verified success), not-yet-started items
        are skipped untouched. ICI switches flip strictly AFTER every
        chip completed, serially — topology writes never race chip
        resets. Full contract: docs/engine.md."""
        chips = [item for item in plan if not item[0].is_ici_switch()]
        switches = [item for item in plan if item[0].is_ici_switch()]

        def flip_item(item: PlanItem) -> bool:
            return self._flip_device(item[0], item[1], snapshot)

        def path_of(item: PlanItem) -> str:
            return item[0].path

        if cap > 1:
            log.info(
                "flipping %d chip(s) with concurrency %d", len(chips), cap
            )
        outcomes = run_flips(
            chips, flip_item,
            concurrency=cap, tracer=self._tracer, label_of=path_of,
            executor=self._flip_executor() if cap > 1 else None,
            recorder=self._flip_recorder(),
        )
        if switches:
            if any(o.status == FAILED for o in outcomes):
                # uniform per-device disposition reporting: untouched
                # switches get an explicit skip, same as queued chips
                outcomes += [
                    FlipOutcome(path_of(item), SKIPPED) for item in switches
                ]
            else:
                # conservative ordering: switches only after ALL chips
                # landed, one at a time (the serial executor path)
                outcomes += run_flips(
                    switches, flip_item,
                    concurrency=1, tracer=self._tracer, label_of=path_of,
                    recorder=self._flip_recorder(),
                )
        ok = True
        for o in outcomes:
            if o.status == FAILED:
                ok = False
                if o.error:  # mismatches already logged in _flip_device
                    log.error("%s: mode flip failed: %s", o.label, o.error)
            elif o.status == SKIPPED:
                log.warning(
                    "%s: flip skipped, device untouched (a sibling device "
                    "failed first)", o.label,
                )
        return ok

    def _flip_device(
        self, dev: TpuChip, changes: Dict[str, str], snapshot: ModeSnapshot
    ) -> bool:
        """ONE device's flip sequence: lock the device node, discard
        stale staged state, stage every divergent domain, ONE reset,
        wait, verify every staged domain, then re-open the node with the
        verified mode's permissions. Returns False on a verify mismatch
        (logged + marked on the span here), raises DeviceError on device
        failure; either way the device stays at the flip-lock perms
        (fail-secure; see device.gate). Runs on a flip-executor worker
        thread when the plan is parallel — the gate's chmod, the
        per-device statefile dir + fcntl lock, the /proc holder scan,
        and the device itself are all device-local; the one shared
        node-wide action, the holder check's runtime restart hook, is
        serialized-and-deduped inside HolderCheck (device/holders.py),
        so sibling flips never race on mutable state."""
        # the reconcile span adopted onto this worker thread owns the
        # flip: its trace id rides both bracket host samples (ISSUE
        # 15), so an incident reader joins "host was loaded" to THIS
        # flip's stitched trace instead of eyeballing timestamps
        parent = self._tracer.current_span()
        with self._flip_recorder().bracket(
            f"flip:{dev.path}",
            trace_id=parent.trace_id if parent is not None else None,
        ), self._tracer.span(
            "flip", device=dev.path, changes=dict(changes)
        ) as flip_span:
            # access-revocation analog of the reference's driver
            # unbind (scripts/cc-manager.sh:40-50): mid-flip, a
            # workload that could open the node observably cannot
            if not dev.is_ici_switch():
                self._gate.lock_for_flip(dev.path)
            # exclusive-hold guarantee (the reference's driver
            # unbind makes this impossible by construction,
            # scripts/cc-manager.sh:40-50): the gate above stops
            # NEW opens, this stops committing under fds that
            # were already open — running the configured runtime
            # restart hook if needed. OVERLAPPED with the stage
            # below (ISSUE 13): the holder scan reads /proc, the
            # stage writes the per-device statefile — disjoint
            # resources, so the scan's wall clock hides behind the
            # stage's. Ordering pinned unchanged: the gate lock
            # above precedes both, and reset only runs after BOTH
            # landed (the join below) — a stage failure while the
            # scan is in flight still joins it, then fails the
            # device with the gate locked and the chip un-reset.
            holder_fut = None
            if self._holder_check.enabled:
                holder_fut = submit_overlapped(
                    lambda: self._holder_check.ensure_free(dev.path)
                )
            # sub-phase spans: the flip's wall clock decomposes
            # into stage/reset/wait_ready/verify so a hardware
            # regression names its phase (the r05 real-chip
            # 1.87->4.43s jump arrived opaque because this
            # span was one block)
            try:
                with self._tracer.span("stage", device=dev.path):
                    dev.discard_staged()
                    for domain, target in changes.items():
                        if domain == "cc":
                            dev.set_cc_mode(target)
                        else:
                            dev.set_ici_mode(target)
            except BaseException:
                # fail-secure under overlap: the scan must not be
                # abandoned (its restart hook may be mid-flight),
                # but the stage's error owns this device's outcome
                if holder_fut is not None:
                    join_overlapped(holder_fut, swallow=True)
                raise
            # holder_check keeps its historical span position (serial
            # trace order is byte-identical); with the overlap on, the
            # span measures the RESIDUAL wait after the stage, and the
            # attr says so
            with self._tracer.span(
                "holder_check", device=dev.path
            ) as holder_span:
                if holder_fut is not None:
                    holder_span.attrs["overlapped"] = True
                    join_overlapped(holder_fut)
                else:
                    self._holder_check.ensure_free(dev.path)
            with self._tracer.span("reset", device=dev.path):
                dev.reset()
            with self._tracer.span("wait_ready", device=dev.path):
                dev.wait_ready(timeout_s=self._boot_timeout_s)
            with self._tracer.span(
                "verify", device=dev.path
            ) as verify_span:
                for domain, target in changes.items():
                    achieved = (
                        dev.query_cc_mode() if domain == "cc"
                        else dev.query_ici_mode()
                    )
                    if achieved != target:
                        log.error(
                            "%s: %s mode verify mismatch: wanted %r got %r",
                            dev.path, domain, target, achieved,
                        )
                        verify_span.status = flip_span.status = "error"
                        flip_span.error = verify_span.error = (
                            f"verify mismatch: {domain} wanted "
                            f"{target!r} got {achieved!r}"
                        )
                        return False
                    # non-tautological verify: a reader that shares
                    # nothing with the flip path but the bytes on
                    # disk must agree too (reference main.py:291-296
                    # re-queries hardware that can genuinely
                    # disagree; our statefile-backed chips would
                    # otherwise only re-read their own bookkeeping)
                    independent = dev.verify_independent(domain)
                    if independent is not None and independent != target:
                        log.error(
                            "%s: independent %s verify disagrees: "
                            "wanted %r, independent reader saw %r",
                            dev.path, domain, target, independent,
                        )
                        verify_span.status = flip_span.status = "error"
                        flip_span.error = verify_span.error = (
                            f"independent verify mismatch: {domain} "
                            f"wanted {target!r} got {independent!r}"
                        )
                        return False
            if not dev.is_ici_switch():
                # a chip whose cc domain didn't change keeps its
                # snapshot mode — the flip can't have moved it
                final_cc = changes.get(
                    "cc", snapshot.get(dev.path, {}).get("cc", "off")
                )
                self._gate.apply_mode(dev.path, final_cc)
        return True
