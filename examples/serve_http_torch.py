"""OpenAI-style HTTP completions endpoint over the PyTorch port's async
front-end (the port's counterpart of ``examples/serve_http.py``).

    PYTHONPATH=src python examples/serve_http_torch.py --device cpu --port 8000
    PYTHONPATH=src python examples/serve_http_torch.py --config gemma3_27b \\
        --max-len 2048 --port 8000      # on the card, full width, bf16 parameters

then::

    curl -s localhost:8000/v1/completions -d \\
        '{"prompt": [3, 1, 4, 1, 5], "max_tokens": 16}'
    curl -sN localhost:8000/v1/completions -d \\
        '{"prompt": [3, 1, 4, 1, 5], "max_tokens": 16, "stream": true}'

Request body fields (OpenAI completions shape): ``prompt`` (list of
token ids, or a string through the demo hasher), ``max_tokens``,
``stream``, and the sampling knobs ``temperature`` (float >= 0, default
0 = greedy), ``top_k`` (int >= 0, 0 = off), ``top_p`` (float in (0, 1],
1 = off), ``seed`` (int).  Sampling is per-request and reproducible:
the same ``seed`` + params replays the identical token stream; when a
request asks for sampling and sends no ``seed``, the server assigns one
from a monotone counter (echoed back as ``"seed"`` in the response) so
concurrent requests never share a stream.  Invalid sampling params are
HTTP 400.

Everything is stdlib: ``asyncio.start_server`` plus a small HTTP/1.1
shim.  One :class:`repro_torch.serve.AsyncEngine` serves every
connection; requests stream tokens back as server-sent events
(``"stream": true``, one ``data:`` chunk per token, ``data: [DONE]``
terminator) or buffer into a single JSON body.  Engine overload surfaces
as HTTP 429 (``AdmissionError`` from the waiting room), bad requests as
HTTP 400, unknown routes as 404, and a TTFT deadline (``--deadline``) as
a 503 with the request's lifecycle events attached.  ``GET /v1/stats``
returns the live ``summary()``; ``--self-test`` starts the server on
``127.0.0.1``, exercises all of the above against it through a raw
socket client, and exits.

Which model: ``--device cpu`` serves the reference example's demo model
(4 layers 'LG', d 128, head dim 32, f32) on the CPU with the kernels'
plain versions.  On the card (the default device) ``--config NAME`` is
required: it serves a registered architecture (``repro_torch.configs``)
at full width and depth with bf16 parameters, random weights from seed 0.
The demo model's attention (head dim 32, f32) is not a shape the paged
kernel is built for, so ``model_config`` refuses it for the card with
the kernel's own error before any work; nothing falls back to the plain
version.

The models have no tokenizer, so ``prompt`` is a list of token ids (a
JSON string is hashed per-character into ids).  This file imports
neither ``jax`` nor ``repro``.
"""
import argparse
import asyncio
import dataclasses
import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionError,
    AsyncEngine,
    ContinuousBatcher,
    InvalidRequestError,
    SamplingParams,
)

#: the reference example's demo model (``serve_http.py:60-72``)
DEMO = ModelConfig(name="serve-http", n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                   d_ff=256, vocab_size=1003, sliding_window=64, layer_pattern="LG",
                   dtype="float32", remat=False)


def model_config(config, device: str) -> ModelConfig:
    """The served config: the demo model, or a registered one with bf16
    parameters.  On the card the paged kernel must be built for its
    attention layers ('G' and 'L'; ``flash_attention.instance`` raises
    otherwise), checked before any parameter is made."""
    cfg = DEMO if config is None else dataclasses.replace(get_config(config),
                                                          param_dtype="bfloat16")
    if device != "cpu" and set(cfg.pattern) & set("GL"):
        flash_attention.instance(cfg.hd, cfg.n_heads // cfg.n_kv_heads)
    return cfg


def build_engine(args):
    cfg = model_config(args.config, args.device)
    params = init_params(cfg, seed=0, device=args.device)
    eng = ContinuousBatcher(
        params, cfg, batch_slots=args.batch, max_len=args.max_len,
        chunk_size=args.chunk, token_budget=args.token_budget or None,
        packed=True, cache="paged", page_size=16,
        max_queue=args.batch * 2,
    )
    return eng, cfg


def ids_from_prompt(prompt, vocab):
    """Token ids from the request ``prompt`` field: a list of ints is
    used as-is; a string is per-character hashed (a stand-in for a
    tokenizer)."""
    if isinstance(prompt, str):
        if not prompt:
            raise ValueError("empty prompt")
        return [(ord(c) * 2654435761) % vocab for c in prompt]
    if (isinstance(prompt, list) and prompt
            and all(isinstance(t, int) for t in prompt)):
        return prompt
    raise ValueError("prompt must be a non-empty string or list of ints")


# ---------------------------------------------------------------------------
# minimal HTTP/1.1 on asyncio streams
# ---------------------------------------------------------------------------


async def read_request(reader):
    """Parse one request; returns (method, path, body_bytes) or None on
    a closed/garbled connection."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
        return None
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, path, _ = lines[0].split(" ", 2)
    except ValueError:
        return None
    length = 0
    for line in lines[1:]:
        if line.lower().startswith("content-length:"):
            length = int(line.split(":", 1)[1])
    body = await reader.readexactly(length) if length else b""
    return method, path, body


def http_response(status, payload, *, ctype="application/json"):
    body = (json.dumps(payload).encode()
            if not isinstance(payload, bytes) else payload)
    return (f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n").encode() + body


STATUS = {200: "200 OK", 400: "400 Bad Request", 404: "404 Not Found",
          429: "429 Too Many Requests", 503: "503 Service Unavailable"}


class Server:
    def __init__(self, frontend, cfg, *, deadline=None, default_max=32):
        self.fe = frontend
        self.cfg = cfg
        self.deadline = deadline
        self.default_max = default_max
        # auto-assigned seeds for sampled requests that don't send one:
        # a counter, not entropy, so server logs alone replay any stream
        self._auto_seed = itertools.count(1)

    def _sampling(self, spec):
        """(SamplingParams or None, effective seed or None) from request
        fields; raises ValueError (-> 400) on invalid params."""
        temperature = float(spec.get("temperature", 0.0))
        top_k = spec.get("top_k", 0)
        top_p = float(spec.get("top_p", 1.0))
        if temperature == 0.0 and top_k == 0 and top_p == 1.0 \
                and "seed" not in spec:
            return None, None
        seed = spec.get("seed")
        if seed is None:
            seed = next(self._auto_seed)
        return SamplingParams(temperature=temperature, top_k=top_k,
                              top_p=top_p, seed=seed), seed

    async def handle(self, reader, writer):
        try:
            parsed = await read_request(reader)
            if parsed is None:
                return
            method, path, body = parsed
            if path == "/v1/stats" and method == "GET":
                writer.write(http_response(STATUS[200], self.fe.summary()))
            elif path == "/v1/completions" and method == "POST":
                await self.completions(writer, body)
            else:
                writer.write(http_response(STATUS[404],
                                           {"error": f"no route {path}"}))
            await writer.drain()
        finally:
            writer.close()

    async def completions(self, writer, body):
        try:
            spec = json.loads(body or b"{}")
            ids = ids_from_prompt(spec.get("prompt"), self.cfg.vocab_size)
            max_tokens = int(spec.get("max_tokens", self.default_max))
            sampling, seed = self._sampling(spec)
            stream = await self.fe.submit(ids, max_tokens,
                                          deadline_s=self.deadline,
                                          sampling=sampling)
        except (TypeError, ValueError, InvalidRequestError) as e:
            writer.write(http_response(STATUS[400], {"error": str(e)}))
            return
        except AdmissionError as e:
            writer.write(http_response(
                STATUS[429], {"error": f"overloaded: {e}"}))
            return

        created = int(time.time())
        if spec.get("stream"):
            writer.write(
                b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                b"Cache-Control: no-cache\r\nConnection: close\r\n\r\n"
            )
            async for tok in stream:
                chunk = {"id": f"cmpl-{stream.uid}", "object": "completion",
                         "created": created,
                         "choices": [{"index": 0, "text": f" {tok}",
                                      "token": tok, "finish_reason": None}]}
                writer.write(f"data: {json.dumps(chunk)}\n\n".encode())
                await writer.drain()
            writer.write(b"data: [DONE]\n\n")
        else:
            await stream.collect()
            if stream.status != "finished":
                writer.write(http_response(STATUS[503], {
                    "error": f"request {stream.status}",
                    "events": [[e.kind, e.detail] for e in stream.events],
                }))
                return
            writer.write(http_response(STATUS[200], {
                "id": f"cmpl-{stream.uid}", "object": "completion",
                "created": created, "model": self.cfg.name,
                **({"seed": seed} if seed is not None else {}),
                "choices": [{
                    "index": 0,
                    "text": " ".join(str(t) for t in stream.tokens),
                    "tokens": stream.tokens,
                    "finish_reason": ("length" if stream.truncated
                                      else "stop"),
                }],
                "usage": {
                    "prompt_tokens": len(stream.request.prompt),
                    "completion_tokens": len(stream.tokens),
                    "ttft_ms": round(stream.ttft * 1e3, 2),
                },
            }))


async def start_server(frontend, cfg, host="127.0.0.1", port=0, *, deadline=None,
                       default_max=32):
    """Serve ``frontend`` (a started ``AsyncEngine``) over HTTP; returns
    (the asyncio server, its port)."""
    srv = Server(frontend, cfg, deadline=deadline, default_max=default_max)
    server = await asyncio.start_server(srv.handle, host, port)
    return server, server.sockets[0].getsockname()[1]


# ---------------------------------------------------------------------------
# self-test client (raw sockets)
# ---------------------------------------------------------------------------


async def http_call(port, method, path, payload=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(payload).encode() if payload is not None else b""
    writer.write(
        (f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
         f"Content-Length: {len(body)}\r\n\r\n").encode() + body
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rbody = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    return status, rbody


async def self_test(port, cfg):
    """The reference example's self-test (``serve_http.py:246-300``)
    against a server on ``port``; raises AssertionError on any miss."""
    # non-streaming completion
    status, body = await http_call(port, "POST", "/v1/completions",
                                   {"prompt": [3, 1, 4, 1, 5],
                                    "max_tokens": 8})
    assert status == 200, (status, body)
    out = json.loads(body)
    toks = out["choices"][0]["tokens"]
    assert len(toks) == 8 and out["usage"]["prompt_tokens"] == 5, out
    # string prompt goes through the demo hasher
    status, body = await http_call(port, "POST", "/v1/completions",
                                   {"prompt": "hello", "max_tokens": 4})
    assert status == 200 and len(json.loads(body)["choices"][0]["tokens"]) == 4
    # streaming: SSE chunks, one per token, [DONE]-terminated, same tokens
    status, body = await http_call(port, "POST", "/v1/completions",
                                   {"prompt": [3, 1, 4, 1, 5],
                                    "max_tokens": 8, "stream": True})
    assert status == 200, (status, body)
    events = [line[len(b"data: "):] for line in body.split(b"\n\n")
              if line.startswith(b"data: ")]
    assert events[-1] == b"[DONE]" and len(events) == 9, events
    streamed = [json.loads(e)["choices"][0]["token"] for e in events[:-1]]
    assert streamed == toks, (streamed, toks)
    # sampled completions: same seed -> identical stream (reproducible),
    # different seed -> different stream, seed echoed when auto-assigned
    sampled = {"prompt": [3, 1, 4, 1, 5], "max_tokens": 8,
               "temperature": 0.8, "top_p": 0.95, "seed": 42}
    _, b1 = await http_call(port, "POST", "/v1/completions", sampled)
    _, b2 = await http_call(port, "POST", "/v1/completions", sampled)
    t1 = json.loads(b1)["choices"][0]["tokens"]
    assert t1 == json.loads(b2)["choices"][0]["tokens"], (b1, b2)
    assert json.loads(b1)["seed"] == 42
    _, b3 = await http_call(port, "POST", "/v1/completions",
                            {**sampled, "seed": 43})
    assert json.loads(b3)["choices"][0]["tokens"] != t1
    status, b4 = await http_call(port, "POST", "/v1/completions",
                                 {k: v for k, v in sampled.items()
                                  if k != "seed"})
    assert status == 200 and isinstance(json.loads(b4)["seed"], int)
    # bad requests (including invalid sampling params)
    for bad in ({"prompt": [], "max_tokens": 4},
                {"prompt": [1, 2], "max_tokens": 0},
                {"prompt": "x" * 10_000, "max_tokens": 4},
                {"prompt": [1, 2], "max_tokens": 4, "temperature": -1.0},
                {"prompt": [1, 2], "max_tokens": 4, "top_p": 0.0},
                {"prompt": [1, 2], "max_tokens": 4, "top_k": -3},
                {"prompt": [1, 2], "max_tokens": 4, "temperature": "hot"}):
        status, _ = await http_call(port, "POST", "/v1/completions", bad)
        assert status == 400, (bad, status)
    status, _ = await http_call(port, "GET", "/v1/nope")
    assert status == 404
    status, body = await http_call(port, "GET", "/v1/stats")
    assert status == 200 and json.loads(body)["frontend_finished"] >= 3.0
    print("self-test OK: completions, streaming SSE, seeded sampling, "
          "errors, stats", flush=True)


async def amain(args):
    """Serve until stopped (or, with ``--self-test``, until the self-test
    has passed); returns the engine."""
    eng, cfg = build_engine(args)
    fe = AsyncEngine(eng, waiting_room=args.waiting_room,
                     queue_timeout=args.queue_timeout or None)
    await fe.start()
    server, port = await start_server(fe, cfg, args.host, args.port,
                                      deadline=args.deadline or None,
                                      default_max=args.max_tokens)
    print(f"serving {cfg.name} on http://{args.host}:{port}/v1/completions "
          f"({args.batch} slots, paged KV, {eng.device})", flush=True)
    try:
        if args.self_test:
            await self_test(port, cfg)
        else:
            async with server:
                await server.serve_forever()
    finally:
        server.close()
        await server.wait_closed()
        await fe.stop(drain=True)
    return eng


def main(argv=None):
    """The command line; returns the engine that served (its counters and
    cache, for a caller that runs the self-test in process)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="0 = pick a free port")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the demo model, plain versions)")
    ap.add_argument("--config", default=None,
                    help="a registered architecture (repro_torch.configs), served at "
                         "full width with bf16 parameters; required on the card, "
                         "default with --device cpu: the demo model")
    ap.add_argument("--batch", type=int, default=8, help="cache slots")
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--token-budget", type=int, default=96)
    ap.add_argument("--max-tokens", type=int, default=32,
                    help="default completion length")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="TTFT SLO in seconds (0 = none); missed -> 503")
    ap.add_argument("--waiting-room", type=int, default=64)
    ap.add_argument("--queue-timeout", type=float, default=0.0)
    ap.add_argument("--self-test", action="store_true",
                    help="start, exercise the endpoint, exit")
    args = ap.parse_args(argv)
    if args.device != "cpu" and args.config is None:
        ap.error("--config NAME is required on the card; the demo model is served "
                 "with --device cpu")
    return asyncio.run(amain(args))


if __name__ == "__main__":
    main()
