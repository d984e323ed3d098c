"""The port's asyncio front-end (``repro_torch.serve.frontend``) on the CPU:
``tests/test_serve_frontend.py``'s matrix over the port's
``ContinuousBatcher``, the streams against the reference ``AsyncEngine``
driving the JAX engine over the same (converted) parameters, the graphs
switch inside the driver's worker thread, and the port's HTTP example's
``--self-test``.

The acceptance bar is the parity class: the exact token streams the
synchronous ``run()`` driver produces must come back through
``AsyncEngine`` streams — dense and paged, packed and not — however
arrivals interleave with steps, and the reference front-end's streams for
the same requests (greedy and seeded sampled).  Everything async adds
(waiting room, queue timeout, deadline drops, cancellation) must shed
load explicitly: every submitted request ends in exactly one of
finished / dropped / cancelled / rejected, and a paged engine ends with
zero referenced pages.  Back-to-back submits have no await point between
them, so they run atomically with respect to the driver task, which makes
the waiting-room overflow tests exact.
"""
import asyncio
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.models import ModelConfig as JConfig  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import AsyncEngine as JAsyncEngine  # noqa: E402
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch import graphs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionError,
    AsyncEngine,
    ContinuousBatcher,
    InvalidRequestError,
    Request,
    RequestStream,
    SamplingParams,
    StepStats,
    StreamEvent,
)

torch.set_num_threads(1)

FIELDS = dict(
    name="serve-fe-t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
    vocab_size=101, layer_pattern="LG", sliding_window=6, dtype="float32", remat=False,
)
CFG = ModelConfig(**FIELDS)
JCFG = JConfig(**FIELDS)

PROMPT_LENS = (3, 5, 12, 4, 8, 6)
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), CFG, device="cpu")


def make_prompts(seed=0, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=n).tolist() for n in lens]


def make_engine(params, batcher=ContinuousBatcher, cfg=CFG, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", 24)
    kw.setdefault("chunk_size", 4)
    return batcher(params, cfg, **kw)


def sync_outputs(params, prompts, max_new=4, **kw):
    eng = make_engine(params, **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=max_new))
    eng.run()
    return {u: r.output for u, r in eng.finished.items()}


async def async_outputs(eng, prompts, max_new=4, frontend=AsyncEngine, sampling=None, **fe_kw):
    async with frontend(eng, **fe_kw) as fe:
        streams = [await fe.submit(p, max_new,
                                   sampling=None if sampling is None else sampling(i))
                   for i, p in enumerate(prompts)]
        outs = await asyncio.gather(*(s.collect() for s in streams))
    assert all(s.status == "finished" for s in streams)
    return {s.uid: out for s, out in zip(streams, outs)}, streams


def paged_kw(cache, packed):
    kw = dict(cache=cache, packed=packed)
    if cache == "paged":
        kw["page_size"] = 8
    return kw


# ---------------------------------------------------------------------------
# Parity: async streams == synchronous driver == the reference front-end
# ---------------------------------------------------------------------------


class TestSyncParity:
    @pytest.mark.parametrize("cache,packed", [("dense", False), ("dense", True),
                                              ("paged", False), ("paged", True)])
    def test_streams_token_identical(self, params, cache, packed):
        """Submitting through the async front-end yields the synchronous
        run() driver's streams, dense and paged, packed and unpacked."""
        prompts = make_prompts()
        want = sync_outputs(params, prompts)
        eng = make_engine(params, **paged_kw(cache, packed))
        got, _ = asyncio.run(async_outputs(eng, prompts))
        assert got == want
        if eng.kv is not None:
            assert eng.kv.tables.used_pages == 0
            eng.kv.check_invariants()

    def test_staggered_arrivals_same_streams(self, params):
        """Arrivals interleaved with steps (sleeps between submits) still
        produce the same per-request streams."""
        prompts = make_prompts(seed=3)
        want = sync_outputs(params, prompts)

        async def go():
            eng = make_engine(params)
            async with AsyncEngine(eng) as fe:
                streams = []
                for p in prompts:
                    streams.append(await fe.submit(p, 4))
                    await asyncio.sleep(0.01)  # let steps interleave
                await asyncio.gather(*(s.collect() for s in streams))
            return {s.uid: s.tokens for s in streams}

        assert asyncio.run(go()) == want

    def test_tokens_stream_incrementally(self, params):
        """__anext__ yields tokens one at a time, in generation order,
        matching the request's final output."""

        async def go():
            eng = make_engine(params, batch_slots=1)
            async with AsyncEngine(eng) as fe:
                stream = await fe.submit(make_prompts()[0], 6)
                seen = [tok async for tok in stream]
            assert seen == stream.request.output and len(seen) == 6
            return stream

        stream = asyncio.run(go())
        assert stream.status == "finished"
        assert isinstance(stream, RequestStream)
        assert all(isinstance(e, StreamEvent) for e in stream.events)

    @pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded_sampled"])
    @pytest.mark.parametrize("cache,packed", [("dense", False), ("paged", True)])
    def test_streams_equal_the_reference_frontend(self, jparams, params, sampled, cache,
                                                  packed):
        """The port's front-end over the port's engine and the reference
        ``AsyncEngine`` over the JAX engine, the same converted parameters,
        the same requests (greedy, or each sampled with its own seed):
        token-identical streams and the same lifecycle kinds."""
        prompts = make_prompts(seed=5)
        kw = paged_kw(cache, packed)
        sp = dict(temperature=0.8, top_k=20, top_p=0.95)
        got, gs = asyncio.run(async_outputs(
            make_engine(params, **kw), prompts, 5,
            sampling=(lambda i: SamplingParams(**sp, seed=i)) if sampled else None))
        want, ws = asyncio.run(async_outputs(
            make_engine(jparams, JBatcher, JCFG, **kw), prompts, 5, frontend=JAsyncEngine,
            sampling=(lambda i: JSamplingParams(**sp, seed=i)) if sampled else None))
        assert got == want
        assert [[e.kind for e in s.events] for s in gs] == [[e.kind for e in s.events]
                                                             for s in ws]


# ---------------------------------------------------------------------------
# The driver's worker thread
# ---------------------------------------------------------------------------


class TestDriverContext:
    @pytest.mark.parametrize("eager", [False, True])
    def test_disable_graphs_holds_inside_the_driver(self, params, eager):
        """The engine step runs in an executor thread; it must see the
        caller's ``graphs.disable_graphs()`` (a ``ContextVar``), or an
        "eager" front-end run would replay graphs on the card."""
        seen = []

        async def go():
            eng = make_engine(params)
            step = eng.step

            def recording_step():
                seen.append(graphs.graphs_enabled())
                step()

            eng.step = recording_step
            async with AsyncEngine(eng) as fe:
                s = await fe.submit(make_prompts()[0], 3)
                await s.collect()

        if eager:
            with graphs.disable_graphs():
                asyncio.run(go())
        else:
            asyncio.run(go())
        assert seen and set(seen) == {not eager}


# ---------------------------------------------------------------------------
# Lifecycle events
# ---------------------------------------------------------------------------


class TestLifecycle:
    def test_event_order_and_timestamps(self, params):
        async def go():
            eng = make_engine(params)
            async with AsyncEngine(eng) as fe:
                stream = await fe.submit(make_prompts()[2], 4)
                await stream.collect()
            return stream

        stream = asyncio.run(go())
        kinds = [e.kind for e in stream.events]
        assert kinds == ["queued", "admitted", "first_token", "finished"]
        times = [e.time for e in stream.events]
        assert times == sorted(times)
        r = stream.request
        assert stream.events[0].time == r.submitted_at
        assert stream.events[1].time == r.admitted_at
        assert stream.events[2].time == r.first_token_at

    def test_truncation_surfaces_in_finish_event(self, params):
        """Force truncation white-box: once the request is in a slot, grow
        max_new_tokens so the slot runs out of cache positions, and check
        the finish event flags the short stream."""

        async def go():
            eng = make_engine(params, batch_slots=1, max_len=8)
            async with AsyncEngine(eng) as fe:
                stream = await fe.submit(make_prompts()[1], 3)
                await stream.__anext__()  # admitted: validation is behind us
                stream.request.max_new_tokens = 10  # 5 + 10 > max_len now
                await stream.collect()
            return stream

        stream = asyncio.run(go())
        assert stream.truncated
        assert len(stream.tokens) == 4  # (max_len 8) - (prompt 5) + 1
        assert stream.events[-1] == dataclasses.replace(
            stream.events[-1], kind="finished", detail="truncated")

    def test_driver_crash_closes_streams(self, params):
        """An unexpected engine error ends every stream (detail
        'driver_error') instead of hanging clients, and stop() re-raises
        the original exception."""

        async def go():
            eng = make_engine(params)
            fe = AsyncEngine(eng)
            await fe.start()
            stream = await fe.submit(make_prompts()[0], 4)

            def boom():
                raise RuntimeError("boom")

            eng.step = boom
            await stream.collect()  # must terminate, not hang
            assert stream.status == "dropped"
            assert stream.events[-1].detail == "driver_error"
            assert fe.in_flight == 0
            with pytest.raises(RuntimeError, match="boom"):
                await fe.stop()

        asyncio.run(go())

    def test_counters_and_summary(self, params):
        async def go():
            eng = make_engine(params)
            async with AsyncEngine(eng) as fe:
                streams = [await fe.submit(p, 3) for p in make_prompts()[:3]]
                await asyncio.gather(*(s.collect() for s in streams))
                return fe.summary()

        summ = asyncio.run(go())
        assert summ["frontend_submitted"] == 3.0
        assert summ["frontend_finished"] == 3.0
        assert summ["frontend_dropped"] == summ["frontend_cancelled"] == 0.0
        assert summ["frontend_waiting"] == summ["frontend_live"] == 0.0
        assert summ["generated_tokens"] == 9.0

    def test_start_twice_and_submit_when_stopped_raise(self, params):
        async def go():
            fe = AsyncEngine(make_engine(params))
            with pytest.raises(RuntimeError, match="not running"):
                await fe.submit([1, 2], 2)
            await fe.start()
            with pytest.raises(RuntimeError, match="already started"):
                await fe.start()
            await fe.stop()
            with pytest.raises(ValueError, match="waiting_room"):
                AsyncEngine(make_engine(params), waiting_room=0)

        asyncio.run(go())


# ---------------------------------------------------------------------------
# Backpressure, timeouts, deadlines, cancellation
# ---------------------------------------------------------------------------


class TestBackpressure:
    def test_waiting_room_overflow_raises(self, params):
        """Engine queue full -> waiting room fills -> AdmissionError to the
        caller."""

        async def go():
            eng = make_engine(params, batch_slots=1, max_queue=1)
            async with AsyncEngine(eng, waiting_room=2) as fe:
                streams = [await fe.submit(make_prompts()[0], 2) for _ in range(2)]
                with pytest.raises(AdmissionError, match="waiting room"):
                    for _ in range(8):
                        streams.append(await fe.submit(make_prompts()[0], 2))
                await asyncio.gather(*(s.collect() for s in streams))
                assert all(s.status == "finished" for s in streams)
                late = await fe.submit(make_prompts()[0], 2)  # the room drained
                await late.collect()
                assert late.status == "finished"

        asyncio.run(go())

    def test_invalid_requests_rejected_eagerly(self, params):
        """validate_request runs at submit: requests the engine can never
        serve fail in the caller, not in the driver loop."""

        async def go():
            eng = make_engine(params, batch_slots=1)
            async with AsyncEngine(eng) as fe:
                with pytest.raises(InvalidRequestError):
                    await fe.submit([], 4)  # empty prompt
                with pytest.raises(InvalidRequestError):
                    await fe.submit([1, 2, 3], 0)  # no tokens requested
                with pytest.raises(InvalidRequestError):
                    await fe.submit(list(range(64)), 4)  # > max_len
                ok = await fe.submit([1, 2, 3], 2)
                await ok.collect()
                with pytest.raises(ValueError, match="already in flight"):
                    stream = await fe.submit([1, 2, 3], 8, uid=7)
                    await fe.submit([4, 5], 2, uid=7)
                await stream.collect()

        asyncio.run(go())

    def test_paged_pool_too_small_is_rejected_eagerly(self, params):
        """A request whose worst case needs more pages than the pool holds
        is an ``AdmissionError`` at submit (FIFO admission would livelock)."""

        async def go():
            eng = make_engine(params, batch_slots=1, cache="paged", page_size=4, num_pages=2)
            async with AsyncEngine(eng) as fe:
                with pytest.raises(AdmissionError, match="pages"):
                    await fe.submit(list(range(1, 10)), 4)
                assert fe.in_flight == 0

        asyncio.run(go())

    def test_queue_timeout_zero_sheds_unadmittable_load(self, params):
        """queue_timeout=0 is 'admit now or drop': with the slot and the
        engine queue both occupied, later requests are dropped at the
        driver's next turn, visibly in events and counters."""

        async def go():
            eng = make_engine(params, batch_slots=1, max_queue=1)
            async with AsyncEngine(eng, queue_timeout=0.0) as fe:
                a = await fe.submit(make_prompts()[2], 8)
                b = await fe.submit(make_prompts()[0], 2)
                c = await fe.submit(make_prompts()[1], 2)
                await asyncio.gather(a.collect(), b.collect(), c.collect())
                return fe, a, b, c

        fe, a, b, c = asyncio.run(go())
        assert a.status == "finished"
        for s in (b, c):
            assert s.status == "dropped"
            assert s.events[-1].kind == "dropped"
            assert s.events[-1].detail == "queue_timeout"
            assert s.tokens == []
        assert fe.counters["dropped"] == 2

    @pytest.mark.parametrize("cache", ["dense", "paged"])
    def test_deadline_drop_reclaims_resources(self, params, cache):
        """A request whose TTFT deadline passes before its first token is
        dropped and cancelled inside the engine: slot and pages come back,
        and the engine keeps serving everyone else."""

        async def go():
            eng = make_engine(params, batch_slots=1, **paged_kw(cache, False))
            async with AsyncEngine(eng) as fe:
                doomed = await fe.submit(make_prompts()[2], 8, deadline_s=0.0)
                live = await fe.submit(make_prompts()[0], 4)
                await asyncio.gather(doomed.collect(), live.collect())
                return eng, doomed, live

        eng, doomed, live = asyncio.run(go())
        assert doomed.status == "dropped"
        assert doomed.events[-1].detail == "deadline"
        assert not doomed.met_deadline
        assert doomed.request.cancelled and doomed.request.output == []
        assert live.status == "finished" and len(live.tokens) == 4
        assert live.met_deadline  # vacuous: no deadline set, token arrived
        assert eng.stats_summary()["cancelled"] == 1.0
        if eng.kv is not None:
            assert eng.kv.tables.used_pages == 0
            eng.kv.check_invariants()

    @pytest.mark.parametrize("cache", ["dense", "paged"])
    def test_stream_cancel_mid_flight(self, params, cache):
        """stream.cancel() after tokens have streamed: the stream ends
        'cancelled', the engine reclaims the slot (and its pages), and a
        queued request takes it over."""

        async def go():
            eng = make_engine(params, batch_slots=1, **paged_kw(cache, False))
            async with AsyncEngine(eng) as fe:
                victim = await fe.submit(make_prompts()[0], 16)
                successor = await fe.submit(make_prompts()[1], 3)
                got = []
                async for tok in victim:
                    got.append(tok)
                    if len(got) == 2:
                        victim.cancel()
                        victim.cancel()  # idempotent
                await successor.collect()
                return fe, victim, successor

        fe, victim, successor = asyncio.run(go())
        assert victim.status == "cancelled"
        assert 2 <= len(victim.tokens) < 16
        assert successor.status == "finished" and len(successor.tokens) == 3
        assert fe.counters["cancelled"] == 1
        assert fe.engine.stats_summary()["cancelled"] == 1.0
        if fe.engine.kv is not None:
            assert fe.engine.kv.tables.used_pages == 0

    def test_stop_without_drain_sheds_in_flight(self, params):
        async def go():
            eng = make_engine(params, batch_slots=1)
            fe = AsyncEngine(eng)
            await fe.start()
            stream = await fe.submit(make_prompts()[0], 19)
            await asyncio.sleep(0.001)  # let it get under way
            await fe.stop(drain=False)
            return fe, stream

        fe, stream = asyncio.run(go())
        assert stream.status == "dropped"
        assert stream.events[-1].detail == "shutdown"
        assert fe.in_flight == 0


# ---------------------------------------------------------------------------
# met_deadline: never a TypeError, False without a first token
# ---------------------------------------------------------------------------


class TestMetDeadline:
    def test_cancelled_before_first_token(self, params):
        async def go():
            eng = make_engine(params, batch_slots=1)
            async with AsyncEngine(eng) as fe:
                blocker = await fe.submit(make_prompts()[2], 8)
                v1 = await fe.submit(make_prompts()[0], 4, deadline_s=60.0)
                v2 = await fe.submit(make_prompts()[1], 4)
                v1.cancel()
                v2.cancel()
                await asyncio.gather(blocker.collect(), v1.collect(), v2.collect())
                return blocker, v1, v2

        blocker, v1, v2 = asyncio.run(go())
        assert blocker.status == "finished" and blocker.met_deadline
        for v in (v1, v2):
            assert v.status == "cancelled" and v.ttft is None
            assert v.met_deadline is False

    def test_queue_timeout_drop_without_deadline(self, params):
        async def go():
            eng = make_engine(params, batch_slots=1, max_queue=1)
            async with AsyncEngine(eng, queue_timeout=0.0) as fe:
                a = await fe.submit(make_prompts()[2], 6)
                b = await fe.submit(make_prompts()[0], 2)  # shed, no deadline
                await asyncio.gather(a.collect(), b.collect())
                return a, b

        a, b = asyncio.run(go())
        assert b.status == "dropped" and b.ttft is None
        assert b.met_deadline is False
        assert a.met_deadline is True

    def test_before_first_token_is_false_not_error(self, params):
        async def go():
            eng = make_engine(params)
            async with AsyncEngine(eng) as fe:
                s = await fe.submit(make_prompts()[0], 2)
                early = s.met_deadline  # queued: ttft is None
                await s.collect()
                return early, s

        early, s = asyncio.run(go())
        assert early is False
        assert s.met_deadline is True


# ---------------------------------------------------------------------------
# sampling, step callbacks, the TTFT split
# ---------------------------------------------------------------------------


class TestFrontendSampling:
    def test_sampled_streams_match_sync_driver(self, params):
        """submit(sampling=...) threads SamplingParams to the engine: async
        streams equal the synchronous driver's seeded streams."""
        prompts = make_prompts()
        sp = SamplingParams(temperature=0.8, top_p=0.95)
        eng = make_engine(params)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=4,
                               sampling=sp.with_seed(i)))
        eng.run()
        want = {u: r.output for u, r in eng.finished.items()}
        got, _ = asyncio.run(async_outputs(make_engine(params), prompts,
                                           sampling=sp.with_seed))
        assert got == want
        assert got != sync_outputs(params, prompts)  # not the greedy streams


class TestStepCallbacks:
    def test_callback_per_step_sync_driver(self, params):
        eng = make_engine(params)
        seen = []
        eng.add_step_callback(seen.append)
        for i, p in enumerate(make_prompts()[:3]):
            eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=3))
        eng.run()
        assert len(seen) == eng.steps
        assert all(isinstance(s, StepStats) for s in seen)
        assert [s.step for s in seen] == list(range(eng.steps))
        assert seen is not eng.step_stats and seen == eng.step_stats

    def test_frontend_step_log_mirrors_engine(self, params):
        async def go():
            eng = make_engine(params)
            async with AsyncEngine(eng) as fe:
                s = await fe.submit(make_prompts()[0], 4)
                await s.collect()
                return fe

        fe = asyncio.run(go())
        assert len(fe.step_log) == fe.engine.steps
        assert all(s.queued_requests >= 0 for s in fe.step_log)


class TestTTFTAccounting:
    def test_hand_computed_split(self, params):
        """The stats_summary percentiles against requests with hand-made
        timestamps: queue_wait = admitted - submitted, admitted_ttft =
        first_token - admitted, ttft = their sum."""
        eng = make_engine(params)
        stamps = [(10.0, 10.5, 11.0), (20.0, 20.25, 21.25), (30.0, 32.0, 32.5)]
        for i, (sub, adm, ftk) in enumerate(stamps):
            r = Request(uid=i, prompt=[1, 2], max_new_tokens=1, output=[5],
                        submitted_at=sub, admitted_at=adm, first_token_at=ftk,
                        finished_at=ftk)
            assert r.ttft == pytest.approx(r.queue_wait + r.admitted_ttft)
            eng.finished[i] = r
        s = eng.stats_summary()
        qw, at = [0.5, 0.25, 2.0], [0.5, 1.0, 0.5]
        assert s["mean_queue_wait"] == pytest.approx(np.mean(qw))
        assert s["p50_queue_wait"] == pytest.approx(np.quantile(qw, 0.5))
        assert s["p99_queue_wait"] == pytest.approx(np.quantile(qw, 0.99))
        assert s["mean_admitted_ttft"] == pytest.approx(np.mean(at))
        assert s["p50_admitted_ttft"] == pytest.approx(np.quantile(at, 0.5))
        assert s["p99_admitted_ttft"] == pytest.approx(np.quantile(at, 0.99))
        assert s["mean_ttft"] == pytest.approx(s["mean_queue_wait"] + s["mean_admitted_ttft"])
        assert s["p50_ttft"] == pytest.approx(np.quantile([1.0, 1.25, 2.5], .5))

    def test_ttft_measured_from_frontend_submit(self, params):
        """A request held in the waiting room accrues TTFT from submit():
        queue_wait covers the waiting room and the engine queue, and ttft =
        queue_wait + admitted_ttft holds on real runs too."""

        async def go():
            eng = make_engine(params, batch_slots=1, max_queue=1)
            async with AsyncEngine(eng, waiting_room=8) as fe:
                streams = [await fe.submit(make_prompts()[0], 4) for _ in range(4)]
                await asyncio.gather(*(s.collect() for s in streams))
            return streams

        streams = asyncio.run(go())
        for s in streams:
            r = s.request
            assert r.ttft == pytest.approx(r.queue_wait + r.admitted_ttft)
        last = streams[-1].request
        assert last.queue_wait > streams[0].request.queue_wait
        assert last.queue_wait >= last.admitted_ttft


# ---------------------------------------------------------------------------
# The HTTP example
# ---------------------------------------------------------------------------


def run_example(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, os.path.join(ROOT, "examples", "serve_http_torch.py"),
                           *args], capture_output=True, text=True, env=env, timeout=timeout)


def test_http_example_self_test_on_the_cpu():
    """``--device cpu --self-test``: completions, SSE streaming, seeded
    sampling, the 400 / 404 / 429 mapping's errors, stats, over a server
    bound to 127.0.0.1 on port 0."""
    out = run_example("--device", "cpu", "--port", "0", "--self-test")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "self-test OK" in out.stdout


def test_http_example_refuses_the_demo_model_for_the_card():
    """On the card the demo model (head dim 32) is refused with the paged
    kernel's own error before any parameter is made, not served by the
    plain version."""
    ex = http_example()
    with pytest.raises(ValueError, match="paged kernel is built for"):
        ex.model_config(None, "cuda")
    cfg = ex.model_config("gemma3_27b", "cuda")  # a built shape: (128, 2)
    assert cfg.param_dtype == "bfloat16" and cfg.d_model == 5376
    assert ex.model_config(None, "cpu") is ex.DEMO


@pytest.mark.parametrize("name", ["mamba2_130m", "recurrentgemma_2b", "internlm2_1_8b",
                                  "starcoder2_7b"])
def test_http_example_admits_the_served_configs_for_the_card(name):
    """Every config the engine serves on the card passes the example's
    check, including one with no attention layer (mamba2-130m: its
    d_model / n_heads is no K4 shape, and no K4 runs)."""
    cfg = http_example().model_config(name, "cuda")
    assert cfg.name == get_config(name).name and cfg.param_dtype == "bfloat16"


def test_http_example_wants_a_config_on_the_card(capsys):
    """The bare command (the card, no ``--config``) is a usage error that
    names the way out, before any model is made."""
    with pytest.raises(SystemExit) as e:
        http_example().main([])
    assert e.value.code == 2
    assert "--config NAME is required on the card" in capsys.readouterr().err


def http_example():
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import serve_http_torch
    finally:
        sys.path.pop(0)
    return serve_http_torch


def test_http_overload_is_429(params):
    """A waiting room of one and a busy engine: a burst of completions gets
    429 for the ones beyond it (``AdmissionError`` from ``submit``)."""
    ex = http_example()

    async def go():
        eng = make_engine(params, batch_slots=1, max_queue=1)
        fe = AsyncEngine(eng, waiting_room=1)
        await fe.start()
        server, port = await ex.start_server(fe, CFG)
        try:
            codes = await asyncio.gather(*(
                ex.http_call(port, "POST", "/v1/completions",
                             {"prompt": [1, 2, 3], "max_tokens": 16}) for _ in range(8)))
        finally:
            server.close()
            await server.wait_closed()
            await fe.stop()
        return sorted(c for c, _ in codes)

    codes = asyncio.run(go())
    assert 429 in codes and 200 in codes and set(codes) <= {200, 429}
