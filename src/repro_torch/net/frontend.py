"""Concurrent serving front end: Future-style handles over one drain loop.

The port of the reference's ``repro.net.frontend``.
:class:`~repro_torch.net.serve.ServingEngine` is deliberately synchronous —
its ``submit``/``drain`` split keeps the execution path testable and the
device work on one thread.  Production traffic is neither: requests arrive
from many threads and callers want to *wait on their own result*, not poll
a results dict.  This module is the bridge:

* :class:`ServingFrontend` wraps an engine with a **background drain
  thread**: producer threads call :meth:`ServingFrontend.submit` (the
  engine's locked, host-only admission path — shape checks, shedding,
  typed rejection all still apply) and get back a :class:`RequestHandle`;
  a daemon thread wakes on every submit and runs ``engine.drain()``, so
  batches keep the engine's double-buffered staging and every CUDA call —
  copies, graph captures and replays, pinned allocations — happens on
  that one thread.
* :class:`RequestHandle` is a minimal Future: :meth:`RequestHandle.result`
  blocks (with timeout) until the request is terminal and returns the
  :class:`~repro_torch.net.serve.RequestResult` — completed, rejected,
  shed, expired, or failed, always typed.

An exception that escapes ``engine.drain()`` — a genuine build, launch or
capture error of a kernel, which the engine never turns into a fallback —
ends the drain thread: every handle still pending resolves with that
error (``result()`` raises it), and later ``submit`` calls raise it too,
so no caller waits on a queue nobody drains.

Delivery rides the engine's completion listeners: every terminal result
fires the frontend's listener, which resolves the matching handle.  A
request can complete *before* its handle is registered (the drain thread
races the submit return path), so results with no handle yet are parked
and claimed at registration — no result is lost to the race.

Use::

    frontend = ServingFrontend(engine)
    with frontend:
        handles = [frontend.submit(x, deadline_us=5e5) for x in stream]
        results = [h.result(timeout=30.0) for h in handles]
"""

from __future__ import annotations

import threading

from repro_torch.obs.trace import get_tracer

from .serve import RequestResult, ServingEngine


class RequestHandle:
    """A Future-style handle for one submitted request."""

    def __init__(self, rid: int) -> None:
        self.id = rid
        self._event = threading.Event()
        self._result: RequestResult | None = None
        self._error: BaseException | None = None

    def _resolve(self, result: RequestResult) -> None:
        self._result = result
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def done(self) -> bool:
        """True once the request is terminal (result available)."""
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> RequestResult:
        """Block until the request is terminal; returns its
        :class:`RequestResult`.  Raises ``TimeoutError`` if ``timeout``
        seconds pass first — the request may still complete later.  Raises
        the drain thread's error if that thread died before the request
        was terminal."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.id} not terminal after {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._result


class ServingFrontend:
    """Thread-safe async layer over one :class:`ServingEngine`.

    ``start()`` launches the daemon drain thread (the context manager does
    it for you); ``submit`` admits from any thread and returns a
    :class:`RequestHandle`; ``stop()`` drains outstanding work and joins
    the thread.  The engine must not be drained by anyone else while the
    frontend owns it.
    """

    def __init__(self, engine: ServingEngine) -> None:
        self.engine = engine
        self._handles: dict[int, RequestHandle] = {}
        self._early: dict[int, RequestResult] = {}
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stopping = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None  # what ended the drain
        engine.add_listener(self._on_result)

    # -- result delivery ----------------------------------------------------

    def _on_result(self, result: RequestResult) -> None:
        # called by the engine (under its lock) for every terminal result;
        # park results whose handle is not registered yet — submit() may
        # still be between engine.submit() and _register()
        with self._lock:
            handle = self._handles.pop(result.id, None)
            if handle is None:
                self._early[result.id] = result
                return
        handle._resolve(result)

    def _register(self, rid: int) -> RequestHandle:
        handle = RequestHandle(rid)
        with self._lock:
            early = self._early.pop(rid, None)
            error = self._error
            if early is None and error is None:
                self._handles[rid] = handle
        if early is not None:
            handle._resolve(early)
        elif error is not None:
            handle._fail(error)
        return handle

    # -- producer API -------------------------------------------------------

    def submit(self, x, *, deadline_us: float | None = None,
               priority: int = 0) -> RequestHandle:
        """Admit one request from any thread; returns its handle.

        Rejections (bad shape, a request on a CUDA device, full queue,
        admission shed) resolve the handle immediately with the typed error
        result — ``submit`` itself never raises for a bad request.  It
        raises the drain thread's error once that thread has died."""
        if self._error is not None:
            raise self._error
        rid = self.engine.submit(x, deadline_us=deadline_us,
                                 priority=priority)
        handle = self._register(rid)
        self._work.set()
        return handle

    # -- drain loop ---------------------------------------------------------

    def _loop(self) -> None:
        try:
            while not self._stopping.is_set():
                # under a tracer the wait for work is a host span
                tracer = get_tracer()
                if tracer.enabled:
                    span = tracer.begin("frontend.wait")
                self._work.wait(timeout=0.05)
                if tracer.enabled:
                    tracer.end(span)
                self._work.clear()
                self.engine.drain()
            self.engine.drain()  # final sweep: nothing submitted is abandoned
        except Exception as e:  # handed to every waiting caller
            self._die(e)

    def _die(self, error: BaseException) -> None:
        """The drain thread's end on ``error``: keep it for later
        ``submit`` calls and resolve every pending handle with it."""
        with self._lock:
            self._error = error
            pending = list(self._handles.values())
            self._handles.clear()
        for handle in pending:
            handle._fail(error)

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self._loop, name="serve-drain", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float | None = 30.0) -> None:
        """Signal the drain thread, let it finish outstanding work, join."""
        if self._thread is None:
            return
        self._stopping.set()
        self._work.set()
        self._thread.join(timeout)
        self._thread = None

    def __enter__(self) -> ServingFrontend:
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
