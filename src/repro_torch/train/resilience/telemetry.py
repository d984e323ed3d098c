"""Compute-time telemetry: bounded buffers + streaming estimators.

Carried over from ``repro.train.resilience.telemetry`` unchanged (numpy only: the port keeps its own
copy); ``tests/test_torch_core.py`` pins it to exact equality.

Collects the per-worker, per-micro-batch latency tensor of every training
step — simulated draws from a ``LatencyModel`` or real host timings (the
monotonic clock around the jitted step, or ``HostTimedEngine``'s
per-micro-batch log) — and keeps

* a **ring buffer** of the most recent ``window`` steps (the rolling
  Algorithm-2 profile the online controller re-estimates tau* from), and
* **streaming** mean/std (Welford) and P² percentile estimators over the
  whole run, so long runs get lifetime statistics at O(1) memory.

Everything is host-side numpy; nothing here is traced.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class RingBuffer:
    """Fixed-capacity ring of equally-shaped numpy records.

    ``push`` overwrites the oldest entry once full; ``window()`` returns
    the retained records oldest-first.  The buffer never holds more than
    ``capacity`` records (the bound the property tests pin).
    """

    def __init__(self, capacity: int, shape: Tuple[int, ...] = ()):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.shape = tuple(shape)
        self._buf = np.zeros((self.capacity, *self.shape), dtype=np.float64)
        self._n = 0  # total pushes ever
        self._head = 0  # next write position

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def total_pushed(self) -> int:
        return self._n

    def push(self, rec) -> None:
        rec = np.asarray(rec, dtype=np.float64)
        if rec.shape != self.shape:
            raise ValueError(f"record shape {rec.shape} != buffer shape {self.shape}")
        self._buf[self._head] = rec
        self._head = (self._head + 1) % self.capacity
        self._n += 1

    def window(self) -> np.ndarray:
        """(k, *shape) retained records, oldest first (k <= capacity)."""
        k = len(self)
        if self._n <= self.capacity:
            return self._buf[:k].copy()
        return np.roll(self._buf, -self._head, axis=0).copy()

    def clear(self) -> None:
        self._n = 0
        self._head = 0


class StreamingMoments:
    """Welford's online mean/variance over scalars or flattened arrays."""

    def __init__(self):
        self.count = 0
        self._mean = 0.0
        self._m2 = 0.0

    def push(self, x) -> None:
        for v in np.asarray(x, dtype=np.float64).ravel():
            self.count += 1
            d = v - self._mean
            self._mean += d / self.count
            self._m2 += d * (v - self._mean)

    @property
    def mean(self) -> float:
        return float(self._mean)

    @property
    def var(self) -> float:
        return float(self._m2 / self.count) if self.count > 1 else 0.0

    @property
    def std(self) -> float:
        return float(np.sqrt(self.var))

    def state_dict(self) -> Dict[str, float]:
        return {"count": int(self.count), "mean": float(self._mean), "m2": float(self._m2)}

    def load_state_dict(self, s: Dict[str, float]) -> None:
        self.count = int(s["count"])
        self._mean = float(s["mean"])
        self._m2 = float(s["m2"])


class P2Quantile:
    """Jain & Chlamtac's P² streaming quantile estimator.

    Five markers, O(1) per observation; exact until five samples have
    arrived, then a piecewise-parabolic approximation.  Good to a few
    percent on the smooth unimodal step-time distributions telemetry
    sees — the controller uses the ring-buffer window (exact) for tau*
    and these only for lifetime summaries and checkpointed state.
    """

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = float(q)
        self._init: List[float] = []
        self._h: Optional[np.ndarray] = None  # marker heights
        self._pos: Optional[np.ndarray] = None  # marker positions
        self._want: Optional[np.ndarray] = None  # desired positions
        self._dwant = np.array([0.0, self.q / 2, self.q, (1 + self.q) / 2, 1.0])

    @property
    def count(self) -> int:
        return len(self._init) if self._h is None else int(self._pos[-1])

    def push(self, x) -> None:
        for v in np.asarray(x, dtype=np.float64).ravel():
            self._push_one(float(v))

    def _push_one(self, v: float) -> None:
        if self._h is None:
            self._init.append(v)
            if len(self._init) == 5:
                self._h = np.sort(np.array(self._init))
                self._pos = np.arange(1.0, 6.0)
                self._want = np.array(
                    [1.0, 1 + 2 * self.q, 1 + 4 * self.q, 3 + 2 * self.q, 5.0]
                )
            return
        h, pos = self._h, self._pos
        if v < h[0]:
            h[0] = v
            k = 0
        elif v >= h[4]:
            h[4] = v
            k = 3
        else:
            k = int(np.searchsorted(h, v, side="right")) - 1
        pos[k + 1 :] += 1.0
        self._want += self._dwant
        # adjust the three interior markers
        for i in (1, 2, 3):
            d = self._want[i] - pos[i]
            if (d >= 1 and pos[i + 1] - pos[i] > 1) or (d <= -1 and pos[i - 1] - pos[i] < -1):
                s = 1.0 if d >= 0 else -1.0
                hp = self._parabolic(i, s)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:  # fall back to linear
                    j = i + int(s)
                    h[i] = h[i] + s * (h[j] - h[i]) / (pos[j] - pos[i])
                pos[i] += s

    def _parabolic(self, i: int, s: float) -> float:
        h, p = self._h, self._pos
        return h[i] + s / (p[i + 1] - p[i - 1]) * (
            (p[i] - p[i - 1] + s) * (h[i + 1] - h[i]) / (p[i + 1] - p[i])
            + (p[i + 1] - p[i] - s) * (h[i] - h[i - 1]) / (p[i] - p[i - 1])
        )

    @property
    def value(self) -> float:
        if self._h is not None:
            return float(self._h[2])
        if not self._init:
            return float("nan")
        return float(np.quantile(np.array(self._init), self.q))

    def state_dict(self) -> Dict[str, Any]:
        return {
            "q": self.q,
            "init": list(self._init),
            "h": None if self._h is None else self._h.tolist(),
            "pos": None if self._pos is None else self._pos.tolist(),
            "want": None if self._want is None else self._want.tolist(),
        }

    def load_state_dict(self, s: Dict[str, Any]) -> None:
        self.q = float(s["q"])
        self._init = list(s["init"])
        self._h = None if s["h"] is None else np.array(s["h"], dtype=np.float64)
        self._pos = None if s["pos"] is None else np.array(s["pos"], dtype=np.float64)
        self._want = None if s["want"] is None else np.array(s["want"], dtype=np.float64)


@dataclasses.dataclass
class StepRecord:
    """One training step's compute-time observation (exportable)."""

    step: int
    worker_time: List[float]  # (N,) per-worker step compute seconds
    host_step_s: Optional[float]  # wall seconds around the jitted step
    tau: float
    drop_fraction: float

    def to_dict(self) -> Dict[str, Any]:
        return {
            "step": self.step,
            "worker_time": [round(float(t), 6) for t in self.worker_time],
            "host_step_s": None if self.host_step_s is None else round(self.host_step_s, 6),
            "tau": self.tau if np.isfinite(self.tau) else None,
            "drop_fraction": round(self.drop_fraction, 6),
        }


_DEFAULT_QUANTILES = (0.5, 0.9, 0.99)


class ComputeTelemetry:
    """Rolling + lifetime view of per-worker compute times.

    ``record`` ingests one step's (N, M) latency tensor; ``window()``
    hands the controller the (W, N, M) rolling profile it re-runs
    Algorithm 2 on.  Micro-batch moments, worker-step-time quantiles AND
    the rolling window survive checkpoints via ``state_dict`` /
    ``load_state_dict``, so a resumed run's controller decides from the
    same profile the uninterrupted run would have seen.
    """

    def __init__(
        self,
        n_workers: int,
        microbatches: int,
        window: int = 64,
        quantiles: Sequence[float] = _DEFAULT_QUANTILES,
        keep_records: int = 4096,
    ):
        self.n_workers = int(n_workers)
        self.microbatches = int(microbatches)
        self._steps_total = 0
        self._ring = RingBuffer(window, (self.n_workers, self.microbatches))
        self.mb_moments = StreamingMoments()  # per-micro-batch seconds
        self.step_moments = StreamingMoments()  # per-worker step seconds
        self.host_moments = StreamingMoments()  # measured host wall seconds
        self.quantiles = {q: P2Quantile(q) for q in quantiles}
        self._record_meta: List[StepRecord] = []
        self._keep_records = int(keep_records)

    # -- ingestion ----------------------------------------------------------

    def record(
        self,
        step: int,
        latencies: np.ndarray,
        host_step_s: Optional[float] = None,
        tau: float = float("inf"),
        drop_fraction: float = 0.0,
    ) -> None:
        t = np.asarray(latencies, dtype=np.float64)
        if t.shape != (self.n_workers, self.microbatches):
            raise ValueError(
                f"latencies {t.shape} != (N={self.n_workers}, M={self.microbatches})"
            )
        self._ring.push(t)
        self._steps_total += 1
        self.mb_moments.push(t)
        per_worker = t.sum(axis=-1)
        self.step_moments.push(per_worker)
        for p2 in self.quantiles.values():
            p2.push(per_worker)
        if host_step_s is not None:
            self.host_moments.push(host_step_s)
        self._record_meta.append(
            StepRecord(step, per_worker.tolist(), host_step_s, float(tau), float(drop_fraction))
        )
        if len(self._record_meta) > self._keep_records:
            self._record_meta = self._record_meta[-self._keep_records :]

    def ingest_host_profile(self, profile: np.ndarray, start_step: int = 0) -> None:
        """Reconcile a ``HostTimedEngine.profile()`` tensor ((I, 1, M),
        ragged rows NaN-padded: micro-batches the engine *dropped*).

        NaNs are filled with the column's observed mean so the window
        stays a dense Algorithm-2 profile — the same convention
        ``core.threshold`` applies.
        """
        prof = np.asarray(profile, dtype=np.float64)
        if prof.ndim != 3:
            raise ValueError(f"profile must be (I, N, M), got {prof.shape}")
        from ...core.threshold import fill_profile_nans

        prof = fill_profile_nans(prof)
        if prof.shape[1] == 1 and self.n_workers > 1:
            prof = np.broadcast_to(prof, (prof.shape[0], self.n_workers, prof.shape[2]))
        if prof.shape[1:] != (self.n_workers, self.microbatches):
            raise ValueError(
                f"profile {prof.shape} incompatible with (N={self.n_workers}, "
                f"M={self.microbatches})"
            )
        for i in range(prof.shape[0]):
            self.record(start_step + i, prof[i])

    # -- views --------------------------------------------------------------

    @property
    def steps(self) -> int:
        return self._steps_total

    @property
    def window_size(self) -> int:
        return len(self._ring)

    def window(self) -> np.ndarray:
        """(W, N, M) rolling latency profile, oldest first."""
        return self._ring.window()

    def summary(self) -> Dict[str, Any]:
        return {
            "steps": self.steps,
            "window": self.window_size,
            "mb_mean_s": self.mb_moments.mean,
            "mb_std_s": self.mb_moments.std,
            "worker_step_mean_s": self.step_moments.mean,
            "worker_step_std_s": self.step_moments.std,
            "host_step_mean_s": self.host_moments.mean if self.host_moments.count else None,
            "worker_step_quantiles_s": {
                f"p{int(q * 100)}": p2.value for q, p2 in self.quantiles.items()
            },
        }

    def export_records(self) -> List[Dict[str, Any]]:
        return [r.to_dict() for r in self._record_meta]

    # -- persistence (checkpointed alongside the controller) ---------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "n_workers": self.n_workers,
            "microbatches": self.microbatches,
            "steps": self.steps,
            "mb_moments": self.mb_moments.state_dict(),
            "step_moments": self.step_moments.state_dict(),
            "host_moments": self.host_moments.state_dict(),
            "quantiles": {str(q): p2.state_dict() for q, p2 in self.quantiles.items()},
            # the rolling window rides along (W*N*M floats) so a resumed
            # run's controller sees the *same* profile the uninterrupted
            # run would — the restore-parity contract
            "window": self._ring.window().tolist(),
        }

    def load_state_dict(self, s: Dict[str, Any]) -> None:
        self.mb_moments.load_state_dict(s["mb_moments"])
        self.step_moments.load_state_dict(s["step_moments"])
        self.host_moments.load_state_dict(s["host_moments"])
        for q, p2 in self.quantiles.items():
            key = str(q)
            if key in s.get("quantiles", {}):
                p2.load_state_dict(s["quantiles"][key])
        self._steps_total = int(s.get("steps", 0))
        self._ring.clear()
        for rec in np.asarray(s.get("window", []), dtype=np.float64).reshape(
            -1, self.n_workers, self.microbatches
        ):
            self._ring.push(rec)
