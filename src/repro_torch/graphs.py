"""Each step as one program: CUDA-graph capture of the serving and training
steps (the port's counterpart of the reference's ``jax.jit`` sites:
``serve/scheduler.py:91`` ``_engine_step``, ``:105``
``_packed_engine_step``, ``train/trainer.py:150`` and ``core/engine.py:62``).

A :class:`StepGraph` wraps a step function ``fn(*inputs) -> outputs`` whose
inputs are tensors and whose other state (parameters, caches, the gradient
accumulator) lives at fixed addresses and is updated in place.  The first
call for a shape key runs ``fn`` once eagerly on a side stream (the warm-up
PyTorch asks for before a capture: it builds the kernels, their host-side
plans and cuBLAS's workspaces) and then captures it into one
``torch.cuda.CUDAGraph`` over static copies of the inputs; the warm-up *is*
that call's step (a capture runs nothing), so its outputs are copied into
the graph's static outputs.  Every later call with the key copies its inputs
into the static buffers (``copy_``) and replays the graph: one launch from
the host instead of one per kernel.  All graphs of a ``StepGraph`` share one
private memory pool.

The outputs are the graph's static tensors: the next replay of any graph of
the same ``StepGraph`` overwrites them, so a caller reads (or copies) them
before the next call.

Graphs are on by default for CUDA tensors.  :func:`disable_graphs` (the
counterpart of ``jax.disable_jit``) runs every step function eagerly
instead, and on the CPU a ``StepGraph`` always calls ``fn`` directly (CUDA
graphs do not exist there).  A capture that fails raises
:class:`GraphCaptureError`; nothing falls back to the eager path.

Launch counters (``kernels.ops.launch_counts``, by kernel and by shape)
count what the card runs: a capture runs nothing, so the launches its
wrappers counted are taken back and recorded with the graph, and every
replay adds them again.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import gc
import time
from typing import Any, Callable, Dict, Hashable, Sequence, Tuple

import numpy as np
import torch

from .kernels import ops as kernel_ops

__all__ = ["GraphCaptureError", "StepGraph", "disable_graphs", "graphs_enabled"]

_ENABLED = contextvars.ContextVar("repro_torch_graphs_enabled", default=True)


class GraphCaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph (an operation that
    syncs the host or allocates outside the graph's pool, on the captured
    path).  Raised, never answered by running the step eagerly."""


@contextlib.contextmanager
def disable_graphs():
    """Run every :class:`StepGraph` eagerly inside the block (the
    counterpart of ``jax.disable_jit()``): the same step functions, one
    launch per kernel."""
    token = _ENABLED.set(False)
    try:
        yield
    finally:
        _ENABLED.reset(token)


def graphs_enabled() -> bool:
    """False inside :func:`disable_graphs`."""
    return _ENABLED.get()


def _as_tuple(out) -> Tuple[torch.Tensor, ...]:
    return out if isinstance(out, tuple) else (out,)


class CudaCapture:
    """How a :class:`StepGraph` warms up and captures on the card: the
    warm-up on a side stream, the capture into a ``torch.cuda.CUDAGraph``
    in one private pool shared by the ``StepGraph``'s graphs."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()

    def warm_up(self, fn: Callable[[], Any]):
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn()
        current.wait_stream(side)
        return out

    def capture(self, fn: Callable[[], Any], warm: Tuple[torch.Tensor, ...]):
        """(graph, outputs, pool bytes): ``fn`` captured (nothing runs), its
        static outputs filled with the warm-up's ``warm``, and what the
        capture added to the device memory held for the pool."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # what torch.cuda.graph does first
        held = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture (torch.cuda.graph collects
        # right before it): collecting an unreachable engine's cycle destroys
        # its graphs, a call that invalidates the capture (seen on the card)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = _as_tuple(fn())
        finally:
            if collecting:
                gc.enable()
        pool_bytes = torch.cuda.memory_reserved(self.device) - held
        current = torch.cuda.current_stream(self.device)
        for o, w in zip(out, warm):
            o.copy_(w)
            w.record_stream(current)  # the warm-up's block outlives this copy
        return graph, out, pool_bytes


@dataclasses.dataclass
class _Entry:
    graph: Any
    inputs: Tuple[torch.Tensor, ...]
    outputs: Tuple[torch.Tensor, ...]
    launches: Dict[Hashable, int]
    capture_s: float
    pool_bytes: int


class StepGraph:
    """One captured graph per shape key of ``fn`` (see the module doc).

    ``fn(*inputs, **static)`` returns a tensor or a tuple of tensors.
    ``__call__(key, *inputs, **static)`` takes the inputs as tensors or
    numpy arrays; ``key`` names their shapes.  The ``static`` keyword
    arguments are Python values that choose the program, such as a
    sampler's mode: a graph is kept for each pair of ``key`` and
    ``static`` (a new pair captures a new graph).  ``capture`` is the
    warm-up and capture strategy, :class:`CudaCapture` on the card; a test
    may pass a stand-in.  On the CPU (no ``capture``) and under
    :func:`disable_graphs` a call is ``fn(*inputs)``."""

    def __init__(self, fn: Callable[..., Any], device, capture=None):
        self.fn = fn
        self.device = torch.device(device)
        if capture is None and self.device.type == "cuda":
            capture = CudaCapture(self.device)
        self._capture = capture
        self._entries: Dict[Hashable, _Entry] = {}

    @property
    def keys(self) -> Sequence[Hashable]:
        return list(self._entries)

    def stats(self) -> Dict[Hashable, Tuple[float, int]]:
        """Per key: (seconds the warm-up and capture took on the host,
        device memory the capture added to the graphs' pool)."""
        return {k: (e.capture_s, e.pool_bytes) for k, e in self._entries.items()}

    def _device_input(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.device, copy=True)

    def load_inputs(self, static: Sequence[torch.Tensor], inputs: Sequence) -> None:
        """Copy a call's inputs into a graph's static buffers."""
        for dst, src in zip(static, inputs):
            dst.copy_(torch.from_numpy(src) if isinstance(src, np.ndarray) else src)

    def __call__(self, key: Hashable, *inputs, **static):
        if self._capture is None or not graphs_enabled():
            return self.fn(*inputs, **static)
        if static:
            key = (key, tuple(sorted(static.items())))
        entry = self._entries.get(key)
        if entry is None:
            entry = self._record(key, inputs, static)
        else:
            if len(inputs) != len(entry.inputs) or any(
                    tuple(x.shape) != tuple(s.shape) for x, s in zip(inputs, entry.inputs)):
                raise ValueError(f"step key {key!r}: input shapes "
                                 f"{[tuple(x.shape) for x in inputs]} differ from the captured "
                                 f"{[tuple(s.shape) for s in entry.inputs]}")
            self.load_inputs(entry.inputs, inputs)
            entry.graph.replay()
            kernel_ops.add_launches(entry.launches)
        return entry.outputs if len(entry.outputs) > 1 else entry.outputs[0]

    def _record(self, key: Hashable, inputs, consts) -> _Entry:
        t0 = time.perf_counter()
        static = tuple(self._device_input(x) for x in inputs)
        warm = _as_tuple(self._capture.warm_up(lambda: self.fn(*static, **consts)))
        before = kernel_ops.launch_counts(by_shape=True)
        try:
            graph, out, pool_bytes = self._capture.capture(lambda: self.fn(*static, **consts),
                                                           warm)
        except RuntimeError as e:
            raise GraphCaptureError(f"capturing the step of key {key!r} failed: {e}") from e
        finally:
            counted = {k: v - before.get(k, 0)
                       for k, v in kernel_ops.launch_counts(by_shape=True).items()}
            kernel_ops.add_launches({k: -v for k, v in counted.items()})  # nothing ran
        entry = _Entry(graph, static, out, {k: v for k, v in counted.items() if v},
                       time.perf_counter() - t0, int(pool_bytes))
        self._entries[key] = entry
        return entry
