"""``repro_torch.serve.frontend`` — the asyncio serving front-end (port of
``repro.serve.frontend``).

``ContinuousBatcher`` is a synchronous engine: callers submit, call
``step`` in a loop, and read finished requests off a dict.  That is the
right shape for parity tests and benchmarks, but not for serving — a
server needs requests to *arrive* while the engine is mid-step, tokens
to stream back per request as they are produced, and load beyond the
engine's admission capacity to be shed deliberately instead of crashing
the caller.  :class:`AsyncEngine` wraps one engine with exactly that:

* a **background driver task** owns the engine step loop; each blocking
  ``step`` runs in a thread-pool executor so the event loop keeps
  accepting arrivals and cancellations while the model computes.  The
  step runs in a copy of the driver's ``contextvars`` context, so
  ``graphs.disable_graphs()`` around the front-end holds inside the
  worker thread too (``run_in_executor`` alone would not carry it);
* ``submit()`` returns a :class:`RequestStream` — an async iterator
  yielding output tokens as engine steps produce them, plus the
  request's lifecycle event log (queued → admitted → first_token →
  finished / dropped / cancelled);
* **backpressure** composes with the engine's admission control: when
  ``ContinuousBatcher.submit`` raises :class:`AdmissionError` (engine
  queue full), the request parks in a bounded **waiting room**; when the
  waiting room is full too, ``submit()`` re-raises ``AdmissionError`` to
  the caller — load shedding is explicit at every layer.  Waiting-room
  entries expire after ``queue_timeout`` seconds without engine
  admission (dropped, not served late);
* per-request **deadline SLOs**: a request with ``deadline_s`` set is
  dropped — cancelled inside the engine, slot and pages reclaimed — if
  its first token hasn't been produced ``deadline_s`` seconds after
  submit.  This is the serving analogue of DropCompute's compute
  threshold applied to *latency*: bounded-delay service with explicit,
  accounted drops instead of unbounded tail latency.

Engine state is only ever touched from the driver's serialization
points: submissions and cancellations land in host-side structures the
event loop owns, and the driver applies them to the engine *between*
steps.  On the card the step (and the CUDA-graph capture of a new step
shape) runs in the worker thread while the event loop goes on: nothing
the loop thread does meanwhile (``submit``, ``cancel``, ``summary``,
publishing tokens, which are host lists) calls CUDA, which a capture in
progress would not survive.  Output streams are token-identical to
driving the same engine synchronously (``tests/test_torch_frontend.py``
pins this, and against the reference front-end): per-slot KV isolation
means a request's greedy stream depends only on its own prompt, never
on how arrivals interleaved.  On the card a token's logits also depend,
by a bf16 rounding, on the shape of the step that computed it (a decode
token in a mixed step or a decode-only one), so ``chip_smoke.py`` holds
the streams to the engine driven synchronously through the same
schedule of submissions and cancels.
"""
from __future__ import annotations

import asyncio
import contextvars
import dataclasses
import itertools
import time
from collections import deque
from typing import AsyncIterator, Deque, Dict, List, Optional, Sequence

from .sampling import SamplingParams
from .scheduler import AdmissionError, ContinuousBatcher, Request, StepStats

#: stream terminator pushed into a RequestStream's token queue
_END = object()

#: lifecycle states a request moves through (events carry the same names)
QUEUED = "queued"
ADMITTED = "admitted"
FINISHED = "finished"
DROPPED = "dropped"
CANCELLED = "cancelled"


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One lifecycle transition of a request, host-timestamped."""

    kind: str  # queued | admitted | first_token | finished | dropped | cancelled
    time: float  # time.perf_counter()
    detail: str = ""  # e.g. the drop reason


class RequestStream:
    """Per-request handle: an async iterator over output tokens.

    Yields tokens in generation order as engine steps produce them; the
    iterator ends when the request finishes, is dropped (queue timeout /
    deadline), or is cancelled — check :attr:`status` to tell which.
    ``tokens`` holds everything yielded so far; ``events`` is the
    lifecycle log.
    """

    def __init__(self, fe: "AsyncEngine", req: Request,
                 deadline_s: Optional[float]):
        self._fe = fe
        self.request = req
        self.deadline_s = deadline_s
        self.tokens: List[int] = []
        self.events: List[StreamEvent] = []
        self.status = QUEUED
        self._published = 0
        self._queue: asyncio.Queue = asyncio.Queue()
        self._record(QUEUED, req.submitted_at)

    # -- identity / accounting ---------------------------------------------

    @property
    def uid(self) -> int:
        return self.request.uid

    @property
    def ttft(self) -> Optional[float]:
        """Submit -> first token (seconds); None until the first token."""
        return self.request.ttft

    @property
    def queue_wait(self) -> Optional[float]:
        return self.request.queue_wait

    @property
    def truncated(self) -> bool:
        return self.request.truncated

    @property
    def met_deadline(self) -> bool:
        """First token arrived within ``deadline_s`` (vacuously true when
        no deadline was set — but False for a request that never produced
        a first token at all)."""
        if self.ttft is None:
            return False
        return self.deadline_s is None or self.ttft <= self.deadline_s

    # -- async iteration ----------------------------------------------------

    def __aiter__(self) -> AsyncIterator[int]:
        return self

    async def __anext__(self) -> int:
        item = await self._queue.get()
        if item is _END:
            raise StopAsyncIteration
        return item

    async def collect(self) -> List[int]:
        """Drain the stream to completion; returns the full output."""
        async for _ in self:
            pass
        return self.tokens

    def cancel(self) -> None:
        """Request cancellation.  Applied by the driver at its next
        serialization point (never mid-step); the stream then ends with
        ``status == "cancelled"``.  Idempotent; a no-op once final."""
        self._fe._request_cancel(self)

    # -- driver-side plumbing ----------------------------------------------

    def _record(self, kind: str, t: Optional[float] = None, detail: str = ""):
        self.events.append(
            StreamEvent(kind, time.perf_counter() if t is None else t, detail)
        )

    def _push(self, toks: Sequence[int]) -> None:
        for t in toks:
            self.tokens.append(int(t))
            self._queue.put_nowait(int(t))

    def _finalize(self, status: str, detail: str = "") -> None:
        self.status = status
        self._record(status, detail=detail)
        self._queue.put_nowait(_END)


class AsyncEngine:
    """Async front-end owning one :class:`ContinuousBatcher`'s step loop.

    Args:
      engine: the engine to drive.  Exclusively owned once ``start`` is
        called: nothing else may call ``step``/``submit``/``cancel`` on
        it until ``stop`` returns.
      waiting_room: bound on requests parked front-end-side when the
        engine's own admission queue is full.  ``submit()`` raises
        :class:`AdmissionError` beyond it — the caller-visible
        backpressure signal.
      queue_timeout: seconds a request may wait (waiting room + engine
        queue) without being admitted to a slot before it is dropped.
        None = wait forever.

    Use as an async context manager, or call ``start``/``stop``::

        async with AsyncEngine(engine) as fe:
            stream = await fe.submit(prompt, max_new_tokens=32)
            async for tok in stream:
                ...
    """

    def __init__(self, engine: ContinuousBatcher, *,
                 waiting_room: int = 256,
                 queue_timeout: Optional[float] = None):
        if waiting_room < 1:
            raise ValueError(f"waiting_room must be >= 1, got {waiting_room}")
        self._engine = engine
        self.waiting_room = waiting_room
        self.queue_timeout = queue_timeout
        self._waiting: Deque[RequestStream] = deque()
        self._live: Dict[int, RequestStream] = {}
        self._cancels: List[RequestStream] = []
        self._uids = itertools.count()
        self._driver: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._stopping = False
        self._abort = False
        self.step_log: List[StepStats] = []  # appended by the engine callback
        self.counters = {"submitted": 0, FINISHED: 0, DROPPED: 0, CANCELLED: 0}
        engine.add_step_callback(self.step_log.append)

    @property
    def engine(self) -> ContinuousBatcher:
        return self._engine

    @property
    def in_flight(self) -> int:
        """Requests accepted but not yet final (waiting room included)."""
        return len(self._waiting) + len(self._live)

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "AsyncEngine":
        if self._driver is not None:
            raise RuntimeError("AsyncEngine already started")
        self._wake = asyncio.Event()
        self._driver = asyncio.get_running_loop().create_task(self._drive())
        return self

    async def stop(self, *, drain: bool = True) -> None:
        """Stop the driver.  ``drain=True`` (default) first waits for
        every in-flight request to reach a final state; ``drain=False``
        cancels everything still in flight and returns."""
        if self._driver is None:
            return
        if drain:
            while self.in_flight:
                await asyncio.sleep(0.002)
        else:
            self._abort = True
        self._stopping = True
        self._wake.set()
        await self._driver
        self._driver = None

    async def __aenter__(self) -> "AsyncEngine":
        return await self.start()

    async def __aexit__(self, exc_type, exc, tb) -> None:
        await self.stop(drain=exc_type is None)

    # -- submission ---------------------------------------------------------

    async def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
                     uid: Optional[int] = None,
                     deadline_s: Optional[float] = None,
                     sampling: Optional[SamplingParams] = None
                     ) -> RequestStream:
        """Accept a request into the system and return its token stream.

        ``sampling`` carries the request's stochastic-decode knobs
        (``serve.sampling.SamplingParams``: temperature / top-k / top-p /
        seed); None = greedy argmax.  Identical (prompt, params, seed)
        replay identical streams — seeding is the caller's namespace, the
        front-end never invents entropy.

        Raises ``InvalidRequestError``/``AdmissionError`` immediately for
        requests the engine can never serve (``validate_request``), and
        ``AdmissionError`` when the waiting room is full — retry later or
        shed the load upstream.
        """
        if self._driver is None or self._stopping:
            raise RuntimeError("AsyncEngine is not running")
        if len(self._waiting) >= self.waiting_room:
            raise AdmissionError(
                f"waiting room full ({len(self._waiting)}/{self.waiting_room})"
            )
        if uid is None:
            uid = next(self._uids)
        if uid in self._live or any(h.uid == uid for h in self._waiting):
            raise ValueError(f"uid {uid} is already in flight")
        req = Request(uid=uid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens,
                      sampling=sampling if sampling is not None
                      else SamplingParams())
        # TTFT measures from *here* — the user-visible submit — not from
        # engine admission; the engine honors a pre-stamped submitted_at
        req.submitted_at = time.perf_counter()
        self._engine.validate_request(req)
        stream = RequestStream(self, req, deadline_s)
        self._waiting.append(stream)
        self.counters["submitted"] += 1
        self._wake.set()
        return stream

    def _request_cancel(self, stream: RequestStream) -> None:
        if stream.status in (QUEUED, ADMITTED):
            self._cancels.append(stream)
            if self._wake is not None:
                self._wake.set()

    # -- driver -------------------------------------------------------------

    async def _drive(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                self._wake.clear()
                self._apply_cancels()
                self._feed()
                self._expire(time.perf_counter())
                if self._abort:
                    self._shed_all()
                if self._engine.busy:
                    # the blocking model step runs off-loop; arrivals and
                    # cancellations land in host structures meanwhile and
                    # are applied at the top of the next iteration
                    await loop.run_in_executor(
                        None, contextvars.copy_context().run, self._engine.step)
                    self._publish()
                elif self._stopping:
                    break
                else:
                    # idle (or gated on queue_timeout): sleep until a
                    # submission/cancel/stop, re-checking expiries
                    # periodically
                    try:
                        await asyncio.wait_for(self._wake.wait(), timeout=0.05)
                    except asyncio.TimeoutError:
                        pass
        except Exception:
            # a driver crash must not strand clients on silent streams:
            # end every in-flight stream (the engine's state is suspect,
            # so don't touch it — no cancel/reclaim) and re-raise so
            # ``stop()`` surfaces the original error
            for stream in list(self._live.values()) + list(self._waiting):
                stream._finalize(DROPPED, detail="driver_error")
                self.counters[DROPPED] += 1
            self._live.clear()
            self._waiting.clear()
            raise

    def _feed(self) -> None:
        """Move waiting-room requests into the engine queue, oldest
        first, until the engine's admission control pushes back."""
        while self._waiting:
            stream = self._waiting[0]
            try:
                self._engine.submit(stream.request)
            except AdmissionError:
                break
            self._waiting.popleft()
            self._live[stream.uid] = stream

    def _expire(self, now: float) -> None:
        """Queue-timeout and TTFT-deadline drops.  Runs after ``_feed``
        so ``queue_timeout=0`` means "drop unless admittable right now"
        — an explicit load-shedding mode, not a race."""
        if self.queue_timeout is not None:
            while self._waiting:
                head = self._waiting[0]
                if now - head.request.submitted_at <= self.queue_timeout:
                    break  # FIFO: everything behind is younger
                self._waiting.popleft()
                head._finalize(DROPPED, detail="queue_timeout")
                self.counters[DROPPED] += 1
        for stream in list(self._live.values()) + list(self._waiting):
            r = stream.request
            if (stream.deadline_s is not None and r.first_token_at is None
                    and now - r.submitted_at > stream.deadline_s):
                self._drop(stream, detail="deadline")

    def _drop(self, stream: RequestStream, detail: str) -> None:
        if stream.uid in self._live:
            # reclaims the slot and every page the request held
            self._engine.cancel(stream.uid)
            del self._live[stream.uid]
        else:
            self._waiting.remove(stream)
        stream._finalize(DROPPED, detail=detail)
        self.counters[DROPPED] += 1

    def _apply_cancels(self) -> None:
        pending, self._cancels = self._cancels, []
        for stream in pending:
            if stream.status not in (QUEUED, ADMITTED):
                continue  # finished/dropped while the cancel was pending
            if stream.uid in self._live:
                self._engine.cancel(stream.uid)
                del self._live[stream.uid]
            else:
                self._waiting.remove(stream)
            stream._finalize(CANCELLED)
            self.counters[CANCELLED] += 1

    def _shed_all(self) -> None:
        for stream in list(self._live.values()) + list(self._waiting):
            self._drop(stream, detail="shutdown")

    def _publish(self) -> None:
        """After a step: stream newly produced tokens, emit lifecycle
        events, retire finished requests."""
        done = []
        for stream in self._live.values():
            r = stream.request
            if stream.status == QUEUED and r.admitted_at is not None:
                stream.status = ADMITTED
                stream._record(ADMITTED, r.admitted_at)
            if len(r.output) > stream._published:
                if stream._published == 0:
                    stream._record("first_token", r.first_token_at)
                stream._push(r.output[stream._published:])
                stream._published = len(r.output)
            if r.finished_at is not None and not r.cancelled:
                done.append(stream)
        for stream in done:
            del self._live[stream.uid]
            stream._finalize(
                FINISHED, detail="truncated" if stream.truncated else ""
            )
            self.counters[FINISHED] += 1

    # -- reporting ----------------------------------------------------------

    def summary(self) -> Dict[str, float]:
        """Engine ``stats_summary`` plus front-end counters."""
        return {
            **self._engine.stats_summary(),
            **{f"frontend_{k}": float(v) for k, v in self.counters.items()},
            "frontend_waiting": float(len(self._waiting)),
            "frontend_live": float(len(self._live)),
        }
