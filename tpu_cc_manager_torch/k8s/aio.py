"""Asyncio kube I/O core — multiplexed, pipelined node reads/writes/watches.

ROADMAP item 4's "next 10x" (ISSUE 13): the coalescing layer
(`k8s/batch.py`) got a steady-state flip down to two node writes, but
those writes still ride Python threads blocking one-request-per-
connection on a contended API server — BENCH_NOTES r03 established
that API round-trip *queueing*, not device work, is the hot path. This
module replaces the thread-per-request model with ONE event loop
multiplexing every request a process makes over a small set of
persistent, **pipelined** HTTP/1.1 connections:

- at most ``TPU_CC_KUBE_CONNS`` connections (default 8), dialed lazily
  and kept warm — concurrent writers beyond the connection budget
  QUEUE on the per-connection window, they never error and never open
  unbounded sockets;
- each connection carries a bounded in-flight window
  (``TPU_CC_KUBE_INFLIGHT``, default 4): up to that many requests are
  written before the first response returns, and HTTP/1.1's in-order
  response rule matches them back FIFO (``_Conn._inflight``);
- the sync client's **exactly-once replay contract is preserved**: a
  request whose connection died before sending ANY response bytes for
  it, on a connection that had already served at least one response
  (the stale keep-alive race — ``BadStatusLine`` in the threaded
  client), replays exactly once on a FRESH dedicated dial; a request
  with partial response bytes, or any failure on a fresh connection,
  is terminal (``ApiException(0)``) because the server may already
  have executed it — a merge patch can never double-apply. A request
  still *queued* when its connection died was never written, so it
  re-dispatches freely (that is not a replay; nothing left the
  process);
- long-lived watch streams get DEDICATED connections (HTTP/1.1 cannot
  interleave an unbounded chunked response with pipelined requests);
  they are counted in ``stats()`` but live outside the request pool;
- client-side flow control (QPS/burst) keeps the sync client's token-
  bucket semantics, awaited with ``asyncio.sleep`` so a throttled
  request parks its coroutine instead of a thread;
- every completed request reports its round-trip seconds (queue wait
  included — the number under OFFERED load, which is what the bench's
  ``flip_write_rtt_p50_s`` axis measures) to ``add_rtt_observer``
  callbacks.

Synchronous callers (the agent, the engine, simlab replicas) use
:mod:`tpu_cc_manager.k8s.aio_bridge`'s ``SyncKubeFacade`` — one loop
thread per process, submit()/gather() — and keep their contracts
unchanged. Full contract: docs/io.md §"The async core".

Known delta vs the threaded client (documented in docs/io.md): the
401 exec-credential invalidate-and-retry loop is not implemented here
— the async core targets the agent/simlab/bench hot paths, where auth
is a static bearer token or none; real-cluster exec-plugin flows keep
using ``HttpKubeClient``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
import urllib.parse
from collections import deque
from typing import (
    TYPE_CHECKING,
    AsyncIterator,
    Callable,
    Dict,
    List,
    Optional,
    Tuple,
)

from tpu_cc_manager_torch.k8s.client import ApiException, ConflictError, KubeConfig

if TYPE_CHECKING:
    # runtime keeps the lazy in-function import (_build_ssl_ctx): ssl
    # loads certs/ciphers at import time and only TLS configs need it
    import ssl

log = logging.getLogger("tpu-cc-manager.k8s.aio")

#: connection budget (shared with the sync client's pool knob: one
#: process, one socket budget, whichever core it runs)
ENV_CONNS = "TPU_CC_KUBE_CONNS"
DEFAULT_CONNS = 8

#: per-connection pipelined in-flight window; 1 = strict request/
#: response lockstep per connection (the serial-equivalence setting
#: tests/test_engine_parallel.py pins span order against)
ENV_WINDOW = "TPU_CC_KUBE_INFLIGHT"
DEFAULT_WINDOW = 4

#: writer backlog admission bound: once every connection's window is
#: full, at most this many writers may QUEUE for a slot; the next one
#: gets an honest 429 and ``queue_rejected_total`` ticks
#: (``tpu_cc_kube_queue_rejected_total`` via obs.py). Unbounded was the
#: overload failure mode docs/io.md §"In-flight window contract" used
#: to admit to — saturation became memory growth and unbounded latency
#: instead of a rejection the caller can pace against (ROADMAP item 3).
ENV_QUEUE = "TPU_CC_KUBE_QUEUE"
DEFAULT_QUEUE = 256

#: socket-level write deadline: ``drain()`` on a wedged peer (zero TCP
#: window) would otherwise park the writer forever — before the
#: request's own read deadline is even armed
DRAIN_TIMEOUT_S = 30.0

#: TCP+TLS dial deadline (a blackholed endpoint fails the dial path's
#: fresh-connection contract instead of hanging it)
CONNECT_TIMEOUT_S = 10.0


def _env_int(name: str, default: int) -> int:
    try:
        v = int(os.environ.get(name, "") or 0)
    except ValueError:
        return default
    return v if v > 0 else default


class _RedialNeeded(Exception):
    """The chosen connection died before this request's bytes were
    written: re-dispatch freely (no replay budget consumed)."""


class _StaleConnClosed(Exception):
    """Zero response bytes for a written request on a previously-
    serving connection — the BadStatusLine-analog, replayable once."""


class _AsyncTokenBucket:
    """The sync client's ``_TokenBucket`` semantics on the loop:
    refill at ``qps``, hold at most ``burst``, park (asyncio.sleep)
    until a token frees. Single-threaded by construction — only loop
    coroutines touch it."""

    def __init__(self, qps: float, burst: int) -> None:
        self.qps = float(qps)
        self.burst = max(1, int(burst))
        self._tokens = float(self.burst)
        self._updated = time.monotonic()

    async def acquire(self) -> float:
        waited = 0.0
        while True:
            now = time.monotonic()
            self._tokens = min(
                float(self.burst),
                self._tokens + (now - self._updated) * self.qps,
            )
            self._updated = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return waited
            wait = (1.0 - self._tokens) / self.qps
            await asyncio.sleep(wait)
            waited += wait


class _Pending:
    """One written-but-unanswered request on a connection."""

    __slots__ = ("method", "path", "future", "got_bytes", "replayed",
                 "sent_on_served")

    def __init__(self, method: str, path: str, replayed: bool) -> None:
        self.method = method
        self.path = path
        self.future: "asyncio.Future[Tuple[int, bytes]]" = (
            asyncio.get_running_loop().create_future()
        )
        self.got_bytes = False  # status line seen for THIS request
        self.replayed = replayed
        #: had the connection served >= 1 complete response AT WRITE
        #: TIME? Replay legality must be judged as of the moment the
        #: bytes left the process, not at failure time: a request
        #: pipelined onto a never-yet-served connection may have
        #: executed server-side even if a sibling's response arrived
        #: before the crash — replaying it could double-apply.
        self.sent_on_served = False


class _Conn:
    """One persistent pipelined connection: a write lock serializing
    request bytes, a FIFO of in-flight requests, a window semaphore
    bounding the pipeline depth, and a reader task matching responses
    back in order."""

    def __init__(self, client: "AsyncKubeClient", window: int) -> None:
        self.client = client
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self._inflight: "deque[_Pending]" = deque()  # ccaudit: allow-unbounded-queue(per-conn FIFO holds at most `window` entries: every append happens under a window-semaphore slot, and admission past the windows is bounded by TPU_CC_KUBE_QUEUE)
        self.window = asyncio.Semaphore(window)
        self.write_lock = asyncio.Lock()
        self.served = 0  # complete responses received on this conn
        self.dead = False
        self.depth = 0  # queued + in-flight (dispatch heuristic)
        self._reader_task: Optional[asyncio.Task] = None

    async def ensure_open(self) -> None:
        if self.dead:
            raise _RedialNeeded()
        if self.writer is None:
            self.reader, self.writer = await self.client._dial()
            self._reader_task = asyncio.get_running_loop().create_task(
                self._read_loop()
            )

    def abort(self) -> None:
        """Hard-close (shutdown): the reader task observes EOF and
        fails the in-flight per the replay policy."""
        self.dead = True
        if self.writer is not None:
            try:
                self.writer.close()
            except Exception:  # ccaudit: allow-swallow(already tearing the socket down; close races are expected)
                pass

    def retire(self) -> None:
        """Stop routing NEW requests here but leave the socket open so
        in-flight pool-mates' responses still drain. Used when one
        pipelined request times out: hard-closing would terminally
        fail an innocent sibling whose write the server already
        executed and was answering. The reader keeps serving what
        remains; the server's idle keep-alive timeout reclaims the
        socket."""
        self.dead = True

    async def send(self, method: str, path: str,
                   payload: Optional[bytes], content_type: str,
                   replayed: bool) -> _Pending:
        """Write one request onto the pipeline; returns its pending
        slot. Raises _RedialNeeded when the conn died before these
        bytes went out (safe to re-dispatch)."""
        async with self.write_lock:
            await self.ensure_open()
            pending = _Pending(method, path, replayed)
            pending.sent_on_served = self.served > 0
            try:
                assert self.writer is not None
                self.writer.write(self.client._encode_request(
                    method, path, payload, content_type,
                    await self.client._auth_header(),
                ))
                # appended under the write lock, BEFORE drain: if drain
                # itself fails the bytes may be on the wire, so the
                # request must already be in the reader's FIFO for the
                # EOF policy to judge (never silently lost)
                self._inflight.append(pending)
                # TimeoutError ⊂ OSError: a wedged-peer drain lands in
                # the same bytes-may-be-on-the-wire branch below
                await asyncio.wait_for(self.writer.drain(),
                                       DRAIN_TIMEOUT_S)
            except (OSError, asyncio.IncompleteReadError) as e:
                self.abort()
                if pending not in self._inflight:
                    # never appended: nothing left the process
                    raise _RedialNeeded() from e
                # drain failed after buffering — the bytes may be on
                # the wire. The reader task may ALREADY have exited on
                # the same death (its EOF pass would then never judge
                # this pending), so run the policy here; it drains the
                # deque, making a second pass a no-op. No awaits in
                # _fail_inflight -> atomic on the loop, no double-set.
                self._fail_inflight()
            return pending

    # ----------------------------------------------------------- reading
    async def _read_loop(self) -> None:
        try:
            assert self.reader is not None
            while True:
                # ccaudit: allow-missing-deadline(reader-task idle read: between responses this SHOULD park indefinitely; every pending request carries its own wait_for deadline, and a wedged socket times those out and retires the conn)
                line = await self.reader.readline()
                if not line:
                    break  # EOF (idle close or mid-pipeline death)
                if not self._inflight:
                    log.warning("unsolicited bytes on pooled conn; closing")
                    break
                head = self._inflight[0]
                head.got_bytes = True
                status, headers = await self._read_head(line)
                body = await self.client._read_body(self.reader, headers)
                pending = self._inflight.popleft()
                self.served += 1
                if not pending.future.done():
                    pending.future.set_result((status, body))
                if headers.get("connection", "").lower() == "close":
                    break
        except (OSError, asyncio.IncompleteReadError, ValueError) as e:
            log.debug("pooled conn reader failed: %s", e)
        finally:
            self._fail_inflight()

    async def _read_head(self, status_line: bytes) -> Tuple[int, Dict[str, str]]:
        try:
            status = int(status_line.split(None, 2)[1])
        except (IndexError, ValueError):
            raise ValueError(f"bad status line {status_line!r}") from None
        headers: Dict[str, str] = {}
        assert self.reader is not None
        while True:
            # ccaudit: allow-missing-deadline(header read on the reader task: the request it serves carries its own wait_for deadline — a wedged mid-header socket times that request out and the conn is retired)
            line = await self.reader.readline()
            if not line:
                raise asyncio.IncompleteReadError(b"", None)
            if line in (b"\r\n", b"\n"):
                return status, headers
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()

    def _fail_inflight(self) -> None:
        self.dead = True
        if self.writer is not None:
            try:
                self.writer.close()
            except Exception:  # ccaudit: allow-swallow(the socket is already gone; close is best-effort)
                pass
        while self._inflight:
            p = self._inflight.popleft()
            if p.future.done():
                continue
            if p.got_bytes:
                # mid-response death: the server executed it; terminal
                p.future.set_exception(ApiException(
                    0, "transport error: connection closed mid-response"
                ))
            elif p.sent_on_served and not p.replayed:
                # zero response bytes AND the conn had served before
                # this request was WRITTEN: the stale keep-alive race —
                # replayable exactly once. (sent_on_served, not the
                # current served count: a sibling's response landing
                # after this request went out does not make this
                # request's execution state any more knowable.)
                p.future.set_exception(_StaleConnClosed())
            else:
                p.future.set_exception(ApiException(
                    0, "transport error: connection closed before any "
                       "response (never-served at write time — not "
                       "replayable)"
                ))


class AsyncKubeClient:
    """Event-loop kube client over pipelined persistent connections.

    Every coroutine here runs on ONE event loop (the bridge's loop
    thread for sync callers); all mutable state is loop-confined — no
    locks beyond the per-connection write lock that keeps pipelined
    request bytes contiguous.
    """

    LIST_PAGE_LIMIT = 500

    def __init__(self, config: KubeConfig,
                 max_conns: Optional[int] = None,
                 window: Optional[int] = None,
                 qps: Optional[float] = None,
                 burst: Optional[int] = None,
                 list_page_limit: Optional[int] = None,
                 max_queue: Optional[int] = None) -> None:
        self.config = config
        self.max_conns = max_conns or _env_int(ENV_CONNS, DEFAULT_CONNS)
        self.window = window or _env_int(ENV_WINDOW, DEFAULT_WINDOW)
        #: writer backlog admission bound (docs/io.md): the count of
        #: writers parked waiting for a window slot may never exceed
        #: this — the next writer past it gets an honest 429
        self.max_queue = max_queue or _env_int(ENV_QUEUE, DEFAULT_QUEUE)
        self._queued = 0
        self.list_page_limit = list_page_limit or self.LIST_PAGE_LIMIT
        self._conns: List[_Conn] = []
        self._ssl_ctx = None
        # serializes first-use context construction: without it two
        # concurrent first requests both see None, both build, and the
        # loser's dial binds a context the winner never sees
        # (ccaudit await-atomicity would flag exactly that shape)
        self._ssl_lock = asyncio.Lock()
        if qps is None:
            try:
                qps = float(os.environ.get("TPU_CC_KUBE_QPS", "") or 0)
            except ValueError:
                qps = 0.0
        self._bucket: Optional[_AsyncTokenBucket] = None
        if qps and qps > 0:
            self._bucket = _AsyncTokenBucket(qps, burst or int(2 * qps))
        # throttle visibility: same surface as the sync client so the
        # simlab runner/faults treat either core interchangeably
        self.throttle_waits = 0
        self.throttle_wait_s_total = 0.0
        self._throttle_observers: List[Callable[[float], None]] = []
        # per-request round-trip observers (queue wait included): the
        # bench's flip_write_rtt_p50_s axis feeds from here
        self._rtt_observers: List[Callable[[str, str, float], None]] = []
        # accounting (read via stats())
        self.dials_total = 0
        self.replays_total = 0
        self.requests_total = 0
        self.watches_total = 0
        #: writes refused at the admission gate (backlog full or the
        #: queue wait outliving the request's own deadline) — the
        #: overflow half of the TPU_CC_KUBE_QUEUE contract
        self.queue_rejected_total = 0
        self._queue_reject_observers: List[Callable[[], None]] = []

    # ------------------------------------------------------------- wiring
    def add_throttle_observer(self, fn: Callable[[float], None]) -> None:
        self._throttle_observers.append(fn)

    def add_rtt_observer(self, fn: Callable[[str, str, float], None]) -> None:
        """``fn(method, path, seconds)`` on every completed request —
        seconds span enqueue to response, so queueing under load is in
        the number (that is the point: it is the latency a flip WRITE
        actually experiences)."""
        self._rtt_observers.append(fn)

    def add_queue_reject_observer(self, fn: Callable[[], None]) -> None:
        """``fn()`` on every write refused at the backlog admission
        gate — obs.py's ``wire_queue_reject_observer`` hooks the
        ``tpu_cc_kube_queue_rejected_total`` counter here."""
        self._queue_reject_observers.append(fn)

    def set_qps(self, qps: float, burst: Optional[int] = None) -> None:
        if qps and qps > 0:
            self._bucket = _AsyncTokenBucket(qps, burst or int(2 * qps))
        else:
            self._bucket = None

    def stats(self) -> dict:
        # callable from any thread by design (the facade exposes it
        # without a bridge hop): every value is a single GIL-atomic
        # load of a monotonic counter — a stale snapshot is fine for
        # metrics, and nothing here is mutated
        return {
            "conns": len(self._conns),  # ccaudit: allow-loop-affinity(GIL-atomic len of a loop-written list; snapshot staleness is fine for metrics)
            "dials": self.dials_total,  # ccaudit: allow-loop-affinity(GIL-atomic read of a monotonic counter)
            "replays": self.replays_total,  # ccaudit: allow-loop-affinity(GIL-atomic read of a monotonic counter)
            "requests": self.requests_total,  # ccaudit: allow-loop-affinity(GIL-atomic read of a monotonic counter)
            "watches": self.watches_total,  # ccaudit: allow-loop-affinity(GIL-atomic read of a monotonic counter)
            "queue_rejected": self.queue_rejected_total,  # ccaudit: allow-loop-affinity(GIL-atomic read of a monotonic counter)
        }

    async def aclose(self) -> None:
        conns, self._conns = self._conns, []
        for c in conns:
            c.abort()

    # ----------------------------------------------------------- plumbing
    async def _dial(self) -> Tuple[asyncio.StreamReader, asyncio.StreamWriter]:
        self.dials_total += 1
        ssl_ctx = None
        if self.config.use_tls:
            ssl_ctx = await self._ensure_ssl_ctx()
        # TimeoutError ⊂ OSError: a blackholed endpoint takes the same
        # terminal fresh-dial-failure path as a refused connection
        return await asyncio.wait_for(
            asyncio.open_connection(
                self.config.host, self.config.port, ssl=ssl_ctx
            ),
            CONNECT_TIMEOUT_S,
        )

    async def _ensure_ssl_ctx(self) -> "ssl.SSLContext":
        # double-checked under an asyncio.Lock: the executor hop below
        # is an interleaving point, so check-then-build must be atomic
        # across coroutines or concurrent first dials build twice
        async with self._ssl_lock:
            if self._ssl_ctx is None:
                # context construction reads CA/cert files off disk: off
                # the loop (our own blocking-in-async rule polices this
                # module)
                loop = asyncio.get_running_loop()
                self._ssl_ctx = await loop.run_in_executor(
                    None, self._build_ssl_ctx
                )
        return self._ssl_ctx

    def _build_ssl_ctx(self) -> "ssl.SSLContext":
        import ssl

        c = self.config
        ctx = ssl.create_default_context(cafile=c.ca_file)
        if c.insecure_skip_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        pair = c.client_cert_pair()
        if pair:
            ctx.load_cert_chain(pair[0], pair[1])
        return ctx

    async def _auth_header(self) -> Optional[str]:
        token = self.config.token
        if token is None and self.config.exec_plugin is not None:
            # the exec plugin may fork a subprocess: never on the loop
            loop = asyncio.get_running_loop()
            token = await loop.run_in_executor(
                None, self.config.bearer_token
            )
        return f"Bearer {token}" if token else None

    def _encode_request(self, method: str, path: str,
                        payload: Optional[bytes], content_type: str,
                        auth: Optional[str]) -> bytes:
        lines = [
            f"{method} {path} HTTP/1.1",
            f"Host: {self.config.host}:{self.config.port}",
            "Accept: application/json",
        ]
        if auth:
            lines.append(f"Authorization: {auth}")
        if payload is not None:
            lines.append(f"Content-Type: {content_type}")
            lines.append(f"Content-Length: {len(payload)}")
        else:
            lines.append("Content-Length: 0")
        head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
        return head + (payload or b"")

    async def _read_body(self, reader: asyncio.StreamReader,
                         headers: Dict[str, str]) -> bytes:
        if headers.get("transfer-encoding", "").lower() == "chunked":
            out = b""
            async for chunk in self._iter_chunks(reader):
                out += chunk
            return out
        length = int(headers.get("content-length", "0") or 0)
        if length == 0:
            return b""
        # ccaudit: allow-missing-deadline(body read on the reader task/watch stream: bounded by the owning request's wait_for deadline or the watch's server-side timeoutSeconds)
        return await reader.readexactly(length)

    @staticmethod
    async def _iter_chunks(reader: asyncio.StreamReader) -> AsyncIterator[bytes]:
        while True:
            # ccaudit: allow-missing-deadline(chunk framing on the reader task: bounded by the owning request's wait_for deadline — the watch path wraps its own frame reads in wait_for separately)
            size_line = await reader.readline()
            if not size_line:
                raise asyncio.IncompleteReadError(b"", None)
            size = int(size_line.strip().split(b";")[0], 16)
            if size == 0:
                # ccaudit: allow-missing-deadline(trailing-CRLF read, same deadline ownership as the frame reads above)
                await reader.readline()  # trailing CRLF
                return
            # ccaudit: allow-missing-deadline(chunk payload read, same deadline ownership as the frame reads above)
            data = await reader.readexactly(size)
            await reader.readexactly(2)  # chunk CRLF  # ccaudit: allow-missing-deadline(chunk-CRLF read, same deadline ownership as the frame reads above)
            yield data

    # ---------------------------------------------------------- dispatch
    def _pick_conn(self) -> _Conn:
        """Least-depth live connection; dial a new one only while under
        the budget AND every live conn already has work in front of it.
        At the budget, callers QUEUE on the chosen conn's window."""
        live = [c for c in self._conns if not c.dead]
        self._conns = live
        idle = min(live, key=lambda c: c.depth) if live else None
        if idle is not None and idle.depth == 0:
            return idle
        if len(live) < self.max_conns:
            conn = _Conn(self, self.window)
            self._conns.append(conn)
            return conn
        assert idle is not None
        return idle

    async def _throttle(self) -> None:
        bucket = self._bucket
        waited = 0.0
        if bucket is not None:
            # ccaudit: allow-missing-deadline(token-bucket pacing: acquire sleeps exactly the computed refill interval — bounded by the bucket's own rate arithmetic, not by a peer)
            waited = await bucket.acquire()
            if waited > 0:
                self.throttle_waits += 1
                self.throttle_wait_s_total += waited
        for fn in self._throttle_observers:
            try:
                fn(waited)
            except Exception:  # ccaudit: allow-async-exception(observer isolation: a broken metrics hook must not fail the request; nothing is in flight here)
                log.debug("throttle observer failed", exc_info=True)

    async def _request(self, method: str, path: str,
                       body: Optional[dict] = None,
                       content_type: str = "application/json",
                       read_timeout: float = 30.0) -> dict:
        await self._throttle()
        payload = (json.dumps(body).encode()
                   if body is not None else None)
        t0 = time.monotonic()
        self.requests_total += 1
        try:
            status, data = await self._round_trip(
                method, path, payload, content_type, read_timeout
            )
        finally:
            rtt = time.monotonic() - t0
            for fn in self._rtt_observers:
                try:
                    fn(method, path, rtt)
                except Exception:  # ccaudit: allow-async-exception(observer isolation: the finally re-raises the round-trip's own failure; the hook must not mask it)
                    log.debug("rtt observer failed", exc_info=True)
        if status == 409:
            raise ConflictError(data.decode("utf-8", "replace")[:200])
        if status >= 400:
            raise ApiException(status, data.decode("utf-8", "replace")[:200])
        return json.loads(data) if data else {}

    def _reject_write(self, reason: str) -> None:
        self.queue_rejected_total += 1
        for fn in self._queue_reject_observers:
            try:
                fn()
            except Exception:  # ccaudit: allow-async-exception(observer isolation: a broken metrics hook must not mask the rejection being raised right below) # ccaudit: allow-swallow(observer isolation: the rejection itself is raised right below; the hook failure is logged)
                log.debug("queue reject observer failed", exc_info=True)
        raise ApiException(429, f"backlog full: {reason}")

    async def _admit(self, conn: _Conn, read_timeout: float) -> None:
        """Take a window slot, honestly. Past the windows at most
        ``max_queue`` writers may park; the next one — and any whose
        queue wait outlives its own read deadline — gets a 429 instead
        of an unbounded spot in line (the TPU_CC_KUBE_QUEUE contract,
        docs/io.md)."""
        if conn.window.locked() and self._queued >= self.max_queue:
            self._reject_write(
                f"{self._queued} writers already queued past the "
                f"window budget (TPU_CC_KUBE_QUEUE={self.max_queue})"
            )
        self._queued += 1
        try:
            # ccaudit: allow-raw-acquire(the admission gate acquires, _round_trip's finally releases: splitting them is what lets the queue wait carry a deadline while the slot spans the whole round trip)
            await asyncio.wait_for(conn.window.acquire(), read_timeout)
        except asyncio.TimeoutError:  # ccaudit: allow-async-exception(_reject_write unconditionally raises ApiException: this handler always propagates, it can never swallow the request path)
            # never acquired: wait_for cancelled the acquire (no slot
            # to release) — the wait itself outlived the deadline the
            # caller gave the whole request
            self._reject_write(
                f"no window slot freed in {read_timeout}s"
            )
        finally:
            # ccaudit: allow-await-atomicity(exact ticket count on one loop: the admission check runs atomically with the increment (no await between them), and each coroutine pairs exactly one increment with this one decrement — interleavings at the acquire await cannot tear it)
            self._queued -= 1

    async def _round_trip(self, method: str, path: str,
                          payload: Optional[bytes], content_type: str,
                          read_timeout: float) -> Tuple[int, bytes]:
        # ccaudit: allow-retry-discipline(_RedialNeeded re-dispatch: each turn retires a provably-stale pooled conn on which NOTHING reached the server; the pool holds at most max_conns stale conns, so this converges without pacing — it is dispatch, not congestion retry)
        while True:  # _RedialNeeded = never-written, re-dispatch freely
            conn = self._pick_conn()
            conn.depth += 1
            try:
                await self._admit(conn, read_timeout)
                try:
                    pending = await conn.send(
                        method, path, payload, content_type,
                        replayed=False,
                    )
                except _RedialNeeded:
                    conn.window.release()
                    continue
                except OSError as e:
                    # the DIAL itself failed: a fresh connection, so
                    # nothing executed server-side — terminal, like the
                    # sync client's fresh-dial failure
                    conn.window.release()
                    conn.abort()
                    raise ApiException(
                        0, f"transport error: {e}"
                    ) from e
                try:
                    result = await asyncio.wait_for(
                        pending.future, read_timeout
                    )
                except asyncio.TimeoutError:
                    # retire, don't abort: pool-mates pipelined behind
                    # (or ahead of) this request may be mid-response —
                    # killing the socket would terminally fail writes
                    # the server already executed. wait_for cancelled
                    # our future, so the reader skips our slot when
                    # (if) the response finally arrives.
                    conn.retire()
                    raise ApiException(
                        0, f"transport error: no response in "
                           f"{read_timeout}s"
                    ) from None
                except _StaleConnClosed:
                    # the exactly-once replay: a FRESH dedicated dial,
                    # never another possibly-stale pooled conn; failure
                    # there is terminal (_fail_inflight: served == 0)
                    self.replays_total += 1
                    result = await self._replay_fresh(
                        method, path, payload, content_type,
                        read_timeout,
                    )
                finally:
                    conn.window.release()
                return result
            finally:
                conn.depth -= 1

    async def _replay_fresh(self, method: str, path: str,
                            payload: Optional[bytes], content_type: str,
                            read_timeout: float) -> Tuple[int, bytes]:
        conn = _Conn(self, window=1)
        try:
            pending = await conn.send(
                method, path, payload, content_type, replayed=True
            )
            try:
                return await asyncio.wait_for(pending.future, read_timeout)
            except asyncio.TimeoutError:
                raise ApiException(
                    0, "transport error: replay got no response in "
                       f"{read_timeout}s"
                ) from None
        except (_RedialNeeded, OSError) as e:
            raise ApiException(
                0, f"transport error: replay connection failed: {e}"
            ) from e
        finally:
            conn.abort()

    # ------------------------------------------------------------- nodes
    async def get_node(self, name: str) -> dict:
        return await self._request("GET", f"/api/v1/nodes/{name}")

    async def list_nodes(self, label_selector: Optional[str] = None) -> List[dict]:
        params: Dict[str, str] = {}
        if label_selector:
            params["labelSelector"] = label_selector
        return await self._paged_list("/api/v1/nodes", params)

    async def patch_node(self, name: str, patch: dict) -> dict:
        return await self._request(
            "PATCH", f"/api/v1/nodes/{name}", body=patch,
            content_type="application/merge-patch+json",
        )

    async def replace_node(self, name: str, node: dict) -> dict:
        return await self._request("PUT", f"/api/v1/nodes/{name}", body=node)

    async def set_node_labels(self, name: str,
                              labels: Dict[str, Optional[str]]) -> dict:
        return await self.patch_node(name, {"metadata": {"labels": labels}})

    async def set_node_annotations(self, name: str,
                                   ann: Dict[str, Optional[str]]) -> dict:
        return await self.patch_node(name, {"metadata": {"annotations": ann}})

    async def _paged_list(self, path: str,
                          params: Dict[str, str]) -> List[dict]:
        items: List[dict] = []
        cont: Optional[str] = None
        while True:
            page = dict(params, limit=str(self.list_page_limit))
            if cont:
                page["continue"] = cont
            resp = await self._request(
                "GET", path + "?" + urllib.parse.urlencode(page)
            )
            items.extend(resp.get("items", []))
            cont = resp.get("metadata", {}).get("continue")
            if not cont:
                return items

    # -------------------------------------------------------------- pods
    async def list_pods(self, namespace: str,
                        label_selector: Optional[str] = None,
                        field_selector: Optional[str] = None) -> List[dict]:
        params: Dict[str, str] = {}
        if label_selector:
            params["labelSelector"] = label_selector
        if field_selector:
            params["fieldSelector"] = field_selector
        return await self._paged_list(
            f"/api/v1/namespaces/{namespace}/pods", params
        )

    async def delete_pod(self, namespace: str, name: str) -> None:
        await self._request(
            "DELETE", f"/api/v1/namespaces/{namespace}/pods/{name}"
        )

    async def evict_pod(self, namespace: str, name: str) -> None:
        await self._request(
            "POST", f"/api/v1/namespaces/{namespace}/pods/{name}/eviction",
            body={
                "apiVersion": "policy/v1", "kind": "Eviction",
                "metadata": {"name": name, "namespace": namespace},
            },
        )

    # ---------------------------------------------------- events / leases
    async def create_event(self, namespace: str, event: dict) -> dict:
        return await self._request(
            "POST", f"/api/v1/namespaces/{namespace}/events", body=event
        )

    async def list_events(self, namespace: str) -> List[dict]:
        resp = await self._request(
            "GET", f"/api/v1/namespaces/{namespace}/events"
        )
        return resp.get("items", [])

    _LEASE_BASE = "/apis/coordination.k8s.io/v1/namespaces"

    async def get_lease(self, namespace: str, name: str) -> dict:
        return await self._request(
            "GET", f"{self._LEASE_BASE}/{namespace}/leases/{name}"
        )

    async def create_lease(self, namespace: str, lease: dict) -> dict:
        return await self._request(
            "POST", f"{self._LEASE_BASE}/{namespace}/leases", body=lease
        )

    async def replace_lease(self, namespace: str, name: str,
                            lease: dict) -> dict:
        return await self._request(
            "PUT", f"{self._LEASE_BASE}/{namespace}/leases/{name}",
            body=lease,
        )

    # --------------------------------------------------- custom resources
    async def list_cluster_custom(self, group: str, version: str,
                                  plural: str) -> List[dict]:
        return await self._paged_list(
            f"/apis/{group}/{version}/{plural}", {}
        )

    async def get_cluster_custom(self, group: str, version: str,
                                 plural: str, name: str) -> dict:
        return await self._request(
            "GET", f"/apis/{group}/{version}/{plural}/{name}"
        )

    async def patch_cluster_custom(self, group: str, version: str,
                                   plural: str, name: str, patch: dict,
                                   subresource: Optional[str] = None) -> dict:
        path = f"/apis/{group}/{version}/{plural}/{name}"
        if subresource:
            path += f"/{subresource}"
        return await self._request(
            "PATCH", path, body=patch,
            content_type="application/merge-patch+json",
        )

    # ------------------------------------------------------------- watch
    async def watch_nodes(self, name: Optional[str] = None,
                          resource_version: Optional[str] = None,
                          timeout_s: int = 300,
                          ) -> AsyncIterator[Tuple[str, dict]]:
        params = {
            "watch": "true",
            "timeoutSeconds": str(timeout_s),
            "allowWatchBookmarks": "true",
        }
        if name:
            params["fieldSelector"] = f"metadata.name={name}"
        if resource_version is not None:
            params["resourceVersion"] = str(resource_version)
        path = "/api/v1/nodes?" + urllib.parse.urlencode(params)
        async for item in self._stream_watch(path, timeout_s):
            yield item

    async def watch_cluster_custom(self, group: str, version: str,
                                   plural: str,
                                   resource_version: Optional[str] = None,
                                   timeout_s: int = 300,
                                   ) -> AsyncIterator[Tuple[str, dict]]:
        params = {"watch": "true", "timeoutSeconds": str(timeout_s)}
        if resource_version is not None:
            params["resourceVersion"] = str(resource_version)
        path = (f"/apis/{group}/{version}/{plural}?"
                + urllib.parse.urlencode(params))
        async for item in self._stream_watch(path, timeout_s):
            yield item

    async def _stream_watch(self, path: str, timeout_s: int,
                            ) -> AsyncIterator[Tuple[str, dict]]:
        """One watch = one DEDICATED connection (an unbounded chunked
        response cannot share a pipelined conn). Watch starts count
        against flow control like the sync client; the stream itself
        is free."""
        await self._throttle()
        self.watches_total += 1
        try:
            reader, writer = await self._dial()
        except OSError as e:
            raise ApiException(0, f"transport error: {e}") from e
        conn_alive = True
        try:
            writer.write(self._encode_request(
                "GET", path, None, "application/json",
                await self._auth_header(),
            ))
            await asyncio.wait_for(writer.drain(), DRAIN_TIMEOUT_S)
            line = await asyncio.wait_for(
                reader.readline(), timeout_s + 30
            )
            if not line:
                raise ApiException(0, "transport error: watch EOF before "
                                      "status line")
            status = int(line.split(None, 2)[1])
            headers: Dict[str, str] = {}
            while True:
                # a peer that wedges mid-header is as dead as one that
                # never sent the status line: same deadline
                hline = await asyncio.wait_for(
                    reader.readline(), timeout_s + 30
                )
                if not hline or hline in (b"\r\n", b"\n"):
                    break
                k, _, v = hline.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            if status >= 400:
                body = await self._read_body(reader, headers)
                raise ApiException(
                    status, body.decode("utf-8", "replace")[:200]
                )
            buf = b""
            async for chunk in self._watch_payload(reader, headers,
                                                   timeout_s):
                buf += chunk
                while b"\n" in buf:
                    raw, buf = buf.split(b"\n", 1)
                    if not raw.strip():
                        continue
                    evt = json.loads(raw)
                    if evt.get("type") == "ERROR":
                        obj = evt.get("object", {})
                        raise ApiException(
                            int(obj.get("code", 500)),
                            obj.get("message", "watch error"),
                        )
                    yield evt["type"], evt["object"]
        except (OSError, asyncio.IncompleteReadError,
                asyncio.TimeoutError) as e:
            conn_alive = False
            raise ApiException(0, f"watch transport error: {e}") from e
        finally:
            try:
                writer.close()
                if conn_alive:
                    await writer.wait_closed()
            except Exception:  # ccaudit: allow-swallow(watch teardown: the socket may already be gone) # ccaudit: allow-async-exception(teardown in a finally after the transport error already re-raised; no futures pending on a dedicated watch conn)
                pass

    async def _watch_payload(self, reader: asyncio.StreamReader,
                             headers: Dict[str, str],
                             timeout_s: int) -> AsyncIterator[bytes]:
        """Chunked (the normal case) or raw-until-EOF payload stream,
        each read bounded so a wedged server can't hang the watcher
        past its own timeout window."""
        deadline = time.monotonic() + timeout_s + 30
        if headers.get("transfer-encoding", "").lower() == "chunked":
            it = self._iter_chunks(reader)
            while True:
                try:
                    chunk = await asyncio.wait_for(
                        it.__anext__(),
                        max(0.1, deadline - time.monotonic()),
                    )
                except StopAsyncIteration:
                    return
                yield chunk
        else:
            while True:
                chunk = await asyncio.wait_for(
                    reader.read(65536),
                    max(0.1, deadline - time.monotonic()),
                )
                if not chunk:
                    return
                yield chunk
