"""Sync façade over the asyncio kube core — one loop thread per process.

The reconcile stack (`agent.py`, `engine.py`, `flipexec.py`, the
batcher, simlab replicas) is synchronous by contract and stays that
way: this module hosts ONE event loop on a daemon thread and exposes

- :func:`get_bridge` — the process-wide :class:`AioBridge`, created
  lazily (one loop thread per process, the ISSUE 13 ownership rule:
  the loop thread owns every ``AsyncKubeClient``'s state; no other
  thread touches it except through ``submit``);
- :class:`AioBridge` — ``call`` (run a coroutine, block for its
  result), ``submit`` (schedule a coroutine OR a blocking callable,
  get a ``concurrent.futures.Future``), ``gather`` (wait for many);
- :class:`SyncKubeFacade` — a full :class:`~…k8s.client.KubeClient`
  whose every verb round-trips through the loop. Calls block the
  calling thread until the response lands, so **at concurrency 1 the
  façade is order-identical to the threaded client**: submit order ==
  completion order, and trace spans (opened on the CALLING thread,
  around the blocking call) parent and sequence byte-identically —
  pinned by tests/test_engine_parallel.py.

The engine's stage/holder-scan overlap
(`flipexec.submit_overlapped`/`join_overlapped`) rides the same
bridge: the side callable runs on the loop's default executor via
``submit``, so one thread pool serves every "hide this synchronous
wait" need in the process.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import queue
import threading
from typing import (
    Any,
    AsyncIterator,
    Callable,
    Coroutine,
    Iterator,
    List,
    Optional,
    Tuple,
)

from tpu_cc_manager_torch.k8s.aio import AsyncKubeClient
from tpu_cc_manager_torch.k8s.client import KubeClient, KubeConfig

log = logging.getLogger("tpu-cc-manager.k8s.aio-bridge")

_bridge: Optional["AioBridge"] = None
_bridge_lock = threading.Lock()


class AioBridge:
    """One event loop on one daemon thread; everything else submits."""

    def __init__(self, name: str = "cc-aio-loop") -> None:
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._thread.start()
        # drain the loop's tasks before the interpreter tears the
        # daemon thread down: abandoned reader tasks would otherwise
        # spray "Task was destroyed but it is pending!" into every
        # CLI/bench exit log
        import atexit

        atexit.register(self.shutdown)

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def shutdown(self, timeout: float = 2.0) -> None:
        """Cancel and await every loop task, then stop the loop. Safe
        to call more than once; registered atexit."""
        if not self.loop.is_running():
            return

        async def _drain() -> None:
            tasks = [
                t for t in asyncio.all_tasks()
                if t is not asyncio.current_task()
            ]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        try:
            asyncio.run_coroutine_threadsafe(
                _drain(), self.loop
            ).result(timeout)
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout)
        except Exception:
            log.debug("bridge shutdown incomplete", exc_info=True)

    # ------------------------------------------------------------ calls
    def call(self, coro: "Coroutine[Any, Any, Any]",
             timeout: Optional[float] = None) -> Any:
        """Run a coroutine on the loop; block for (and return) its
        result. The ONE way sync code reaches async state."""
        return asyncio.run_coroutine_threadsafe(
            coro, self.loop
        ).result(timeout)

    def submit(self, fn: Callable, *args: Any, **kwargs: Any
               ) -> "concurrent.futures.Future":
        """Schedule work without waiting: a coroutine function runs as
        a loop task; a plain callable runs on the loop's default
        executor (a thread pool — for synchronous waits worth hiding,
        like the flip path's holder scan). Returns a concurrent
        Future; pair with :meth:`gather`."""
        if asyncio.iscoroutinefunction(fn):
            return asyncio.run_coroutine_threadsafe(
                fn(*args, **kwargs), self.loop
            )
        out: "concurrent.futures.Future" = concurrent.futures.Future()

        def _dispatch() -> None:
            exec_fut = self.loop.run_in_executor(
                None, lambda: fn(*args, **kwargs)
            )

            def _done(f: "asyncio.Future") -> None:
                if f.cancelled():
                    out.cancel()
                elif f.exception() is not None:
                    out.set_exception(f.exception())
                else:
                    # ccaudit: allow-missing-deadline(done-callback: f has already settled — this result() returns immediately, it never waits)
                    out.set_result(f.result())

            exec_fut.add_done_callback(_done)

        self.loop.call_soon_threadsafe(_dispatch)
        return out

    @staticmethod
    def gather(futures: List["concurrent.futures.Future"],
               timeout: Optional[float] = None) -> List[Any]:
        """Block until every future resolves; first exception wins
        AFTER all have settled (nothing is abandoned mid-flight —
        the flip path's fail-secure join relies on this)."""
        concurrent.futures.wait(futures, timeout=timeout)
        return [f.result(timeout=0) for f in futures]


def get_bridge() -> AioBridge:
    """The process-wide loop thread (lazily created)."""
    global _bridge
    with _bridge_lock:
        if _bridge is None:
            _bridge = AioBridge()
        return _bridge


#: watch-pump sentinel: clean end of stream
_DONE: object = object()


class SyncKubeFacade(KubeClient):
    """`KubeClient` implemented by round-tripping every verb through
    an :class:`AsyncKubeClient` on the bridge loop. Thread-safe: any
    number of threads (flip executor workers, simlab replicas sharing
    one façade in shared-loop mode) may call concurrently — their
    requests multiplex onto the loop's pipelined connection pool and
    each caller blocks only on its own response future."""

    def __init__(self, config: KubeConfig,
                 *,
                 max_conns: Optional[int] = None,
                 window: Optional[int] = None,
                 qps: Optional[float] = None,
                 burst: Optional[int] = None,
                 bridge: Optional[AioBridge] = None,
                 aio: Optional[AsyncKubeClient] = None) -> None:
        self.config = config
        self.bridge = bridge or get_bridge()
        self.aio = aio or AsyncKubeClient(
            config, max_conns=max_conns, window=window,
            qps=qps, burst=burst,
        )

    # ------------------------------------------------- throttle surface
    # (same attribute contract as HttpKubeClient, so the simlab runner
    # and fault injector drive either core interchangeably)
    @property
    def throttle_waits(self) -> int:
        # ccaudit: allow-loop-affinity(GIL-atomic read of a loop-written monotonic counter; a bridge hop per metrics scrape would cost more than the staleness it buys)
        return self.aio.throttle_waits

    @property
    def throttle_wait_s_total(self) -> float:
        # ccaudit: allow-loop-affinity(GIL-atomic read of a loop-written float accumulator; snapshot staleness is fine for metrics)
        return self.aio.throttle_wait_s_total

    def add_throttle_observer(self, fn: Callable[[float], None]) -> None:
        self.aio.add_throttle_observer(fn)

    def add_rtt_observer(self, fn: Callable[[str, str, float], None]) -> None:
        self.aio.add_rtt_observer(fn)

    def add_queue_reject_observer(self, fn: Callable[[], None]) -> None:
        self.aio.add_queue_reject_observer(fn)

    def set_qps(self, qps: float, burst: Optional[int] = None) -> None:
        # swap the bucket ON the loop: bucket state is loop-confined
        self.bridge.loop.call_soon_threadsafe(
            self.aio.set_qps, qps, burst
        )

    def stats(self) -> dict:
        return self.aio.stats()

    def close(self) -> None:
        try:
            self.bridge.call(self.aio.aclose(), timeout=5)
        except Exception:
            log.debug("async client close failed", exc_info=True)

    # ------------------------------------------------------------ verbs
    def get_node(self, name: str) -> dict:
        return self.bridge.call(self.aio.get_node(name))

    def list_nodes(self, label_selector: Optional[str] = None) -> List[dict]:
        return self.bridge.call(self.aio.list_nodes(label_selector))

    def patch_node(self, name: str, patch: dict) -> dict:
        return self.bridge.call(self.aio.patch_node(name, patch))

    def replace_node(self, name: str, node: dict) -> dict:
        return self.bridge.call(self.aio.replace_node(name, node))

    def list_pods(self, namespace: str,
                  label_selector: Optional[str] = None,
                  field_selector: Optional[str] = None) -> List[dict]:
        return self.bridge.call(self.aio.list_pods(
            namespace, label_selector, field_selector
        ))

    def delete_pod(self, namespace: str, name: str) -> None:
        self.bridge.call(self.aio.delete_pod(namespace, name))

    def evict_pod(self, namespace: str, name: str) -> None:
        self.bridge.call(self.aio.evict_pod(namespace, name))

    def create_event(self, namespace: str, event: dict) -> dict:
        return self.bridge.call(self.aio.create_event(namespace, event))

    def list_events(self, namespace: str) -> List[dict]:
        return self.bridge.call(self.aio.list_events(namespace))

    def get_lease(self, namespace: str, name: str) -> dict:
        return self.bridge.call(self.aio.get_lease(namespace, name))

    def create_lease(self, namespace: str, lease: dict) -> dict:
        return self.bridge.call(self.aio.create_lease(namespace, lease))

    def replace_lease(self, namespace: str, name: str,
                      lease: dict) -> dict:
        return self.bridge.call(self.aio.replace_lease(
            namespace, name, lease
        ))

    def list_cluster_custom(self, group: str, version: str,
                            plural: str) -> List[dict]:
        return self.bridge.call(self.aio.list_cluster_custom(
            group, version, plural
        ))

    def get_cluster_custom(self, group: str, version: str,
                           plural: str, name: str) -> dict:
        return self.bridge.call(self.aio.get_cluster_custom(
            group, version, plural, name
        ))

    def patch_cluster_custom(self, group: str, version: str,
                             plural: str, name: str, patch: dict,
                             subresource: Optional[str] = None) -> dict:
        return self.bridge.call(self.aio.patch_cluster_custom(
            group, version, plural, name, patch, subresource=subresource
        ))

    # ------------------------------------------------------------ watch
    def watch_nodes(self, name: Optional[str] = None,
                    resource_version: Optional[str] = None,
                    timeout_s: int = 300,
                    ) -> Iterator[Tuple[str, dict]]:
        return self._pump_watch(self.aio.watch_nodes(
            name=name, resource_version=resource_version,
            timeout_s=timeout_s,
        ), timeout_s)

    def watch_cluster_custom(self, group: str, version: str,
                             plural: str,
                             resource_version: Optional[str] = None,
                             timeout_s: int = 300,
                             ) -> Iterator[Tuple[str, dict]]:
        return self._pump_watch(self.aio.watch_cluster_custom(
            group, version, plural,
            resource_version=resource_version, timeout_s=timeout_s,
        ), timeout_s)

    def _pump_watch(self, agen: "AsyncIterator[Tuple[str, dict]]",
                    timeout_s: int,
                    ) -> Iterator[Tuple[str, dict]]:
        """Bridge an async event stream to a plain sync iterator: a
        loop task pumps into a queue; the consuming thread blocks on
        it. Abandoning the iterator (watcher stop, GC) cancels the
        pump task so the dedicated watch connection is reclaimed."""
        # ccaudit: allow-unbounded-queue(cross-thread hand-off for ONE watch stream: a bounded put would stall the shared loop thread behind a slow consumer, wedging every other bridge user; the stream itself is bounded by the server-side watch timeoutSeconds)
        q: "queue.Queue" = queue.Queue()

        async def pump() -> None:
            try:
                async for item in agen:
                    q.put(item)
                q.put(_DONE)
            except asyncio.CancelledError:
                q.put(_DONE)
                raise
            except BaseException as e:  # ApiException included
                q.put(e)

        fut = asyncio.run_coroutine_threadsafe(pump(), self.bridge.loop)
        try:
            while True:
                # bounded block so a dead pump can never hang a watcher
                # thread past the stream's own lifetime
                try:
                    item = q.get(timeout=timeout_s + 60)
                except queue.Empty:
                    from tpu_cc_manager_torch.k8s.client import ApiException

                    raise ApiException(
                        0, "watch bridge stalled past the stream "
                           "timeout"
                    ) from None
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            fut.cancel()
