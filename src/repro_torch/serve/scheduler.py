"""Continuous-batching serving engine with chunked prefill (port of
``repro.serve.scheduler``).

A fixed pool of B cache slots; requests are admitted into free slots as
they complete.  Every engine iteration schedules a mixed batch: decode
slots consume one token, prefill slots up to ``chunk_size`` prompt tokens,
under a per-step ``token_budget`` (the serving analogue of DropCompute's
tau: prefill past the budget is deferred to the next iteration, decode is
unconditional, and the oldest prefill always gets at least one token).
``packed=True`` runs the token-packed step (``serve.packing`` +
``models.model.packed_prefill``) so granted tokens alone set the compute;
``cache="paged"`` puts KV in a page pool with prefix sharing
(``serve.kv``).  On the card each step shape runs as one captured CUDA
graph (``repro_torch.graphs.StepGraph``, the reference's jitted
``_engine_step`` / ``_packed_engine_step``): the embedding through the
greedy tokens, over the step's inputs and the paged kernel's tile plans
(made on the host) copied into static buffers; admission, prefix sharing
and copy-on-write page copies run eagerly between the replays, in place on
the same tensors.  Decode is sampled per request (``Request.sampling``,
``serve.sampling``): the step's logits feed the sampler inside the same
program, with each row's parameters and its key's output index copied into
the step's static buffers like its tokens, so a sampled step replays as a
graph like a greedy one (one graph per step shape and sampler program);
the default params are greedy and give the greedy program's tokens.
``spec=`` (``serve.spec``) verifies up to k proposed tokens per decode slot
in one (B, k + 1) grant, keeps the prefix the target's sampled columns
confirm plus a bonus token, and rolls the rejected tail back
(``KVCache.trim_slot`` on the paged layout).  'R' (RG-LRU) and 'M' (Mamba-2) layers carry per-slot
recurrent state, updated in place like the KV pools (so a replay carries
it): a recycled slot's rows are zeroed on admission, and prefix sharing
(and the in-flight prefix dedup that waits for it) is off for them.  MoE
layers run the dense dispatch, or with ``capacity_factor`` the capacity
form (``models.moe.apply_moe_capacity``), whose dropped routes each step
reads back into ``StepStats.expert_overflow``.
Scheduling, deferral and accounting match the reference exactly; ``tests/test_torch_serve.py`` holds the streams, step counts,
per-step stats and block tables to it.

Not ported yet (raises a typed error): a device mesh (``dist``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..graphs import StepGraph
from ..models.config import ModelConfig
from ..models.model import (
    UnsupportedPatternError,
    chunk_plans,
    compute_params,
    init_decode_cache,
    packed_plans,
    packed_prefill,
    params_device,
    prefill_chunk,
    require_chunkable,
)
from . import packing
from .kv import KVCache, KVCacheSpec, reset_recurrent_state
from .sampling import SamplingParams, sample_mode, sample_rows
from .spec import Proposer, SpecConfig, accept_sampled

__all__ = [
    "AdmissionError",
    "ContinuousBatcher",
    "EngineStateError",
    "InvalidRequestError",
    "Request",
    "StepStats",
    "UnsupportedDistError",
    "UnsupportedPatternError",
]


class UnsupportedDistError(NotImplementedError):
    """A serving mode was combined with a ``Distribution`` it cannot run
    under.  The port has no device mesh yet, so any ``dist`` raises."""


class AdmissionError(RuntimeError):
    """Raised by ``submit`` when the engine's wait queue is full, or when
    the paged pool can never hold a request."""


class InvalidRequestError(ValueError):
    """A request the engine can never serve correctly (empty prompt,
    ``max_new_tokens < 1``, longer than a slot)."""


class EngineStateError(RuntimeError):
    """An engine lifecycle operation was called in the wrong state."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    output: List[int] = dataclasses.field(default_factory=list)
    #: finished short of ``max_new_tokens`` (its slot ran out of positions)
    truncated: bool = False
    #: aborted via ``ContinuousBatcher.cancel`` before finishing
    cancelled: bool = False
    # --- latency accounting (filled in by the engine) ---
    submitted_at: Optional[float] = None
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    admitted_step: Optional[int] = None
    first_token_step: Optional[int] = None

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens

    @property
    def ttft(self) -> Optional[float]:
        """Seconds from submit to first output token (queue wait included)."""
        if self.submitted_at is None or self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def queue_wait(self) -> Optional[float]:
        """Seconds spent waiting for a cache slot (submit -> admission)."""
        if self.submitted_at is None or self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    @property
    def admitted_ttft(self) -> Optional[float]:
        """Seconds from slot admission to first output token."""
        if self.admitted_at is None or self.first_token_at is None:
            return None
        return self.first_token_at - self.admitted_at

    @property
    def ttft_steps(self) -> Optional[int]:
        """Engine iterations from slot admission to first output token."""
        if self.admitted_step is None or self.first_token_step is None:
            return None
        return self.first_token_step - self.admitted_step + 1


@dataclasses.dataclass
class StepStats:
    """Per-iteration scheduling record (the reference's fields)."""

    step: int
    decode_tokens: int  # decode slots fed (1 baseline token each)
    prefill_tokens: int  # prompt tokens consumed this step
    deferred_tokens: int  # prompt tokens pushed past the deadline
    wall_time: float  # host-measured step duration (seconds), device synced
    shared_tokens: int = 0  # prompt tokens covered by prefix-cache pages
    used_pages: int = 0  # paged layout: pages referenced after this step
    draft_tokens: int = 0  # speculative draft tokens verified this step
    accepted_tokens: int = 0  # drafts the target model accepted
    queued_requests: int = 0  # requests waiting for a slot at step start
    #: scheduled tokens past ``token_budget`` this step (decode baselines
    #: and the starvation guard may exceed it by design); 0 with no budget
    budget_overshoot: int = 0
    #: routed (token, expert) choices the capacity-factor MoE dispatch
    #: dropped to the residual path this step (0 for the dense dispatch)
    expert_overflow: int = 0

    @property
    def scheduled_tokens(self) -> int:
        return self.decode_tokens + self.draft_tokens + self.prefill_tokens


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0  # next absolute position to write

    @property
    def free(self) -> bool:
        return self.req is None

    @property
    def prefilling(self) -> bool:
        return self.req is not None and self.pos < len(self.req.prompt)


class ContinuousBatcher:
    """Engine: admit / step / drain.

    Args as in the reference: ``batch_slots`` cache slots, ``max_len``
    positions per slot, ``chunk_size`` prompt tokens per slot per step,
    ``token_budget`` scheduled tokens per step (None = uncapped),
    ``max_queue`` (``submit`` raises ``AdmissionError`` beyond it),
    ``packed`` (token-packed step), ``cache`` ("dense", "paged" or a
    ``KVCacheSpec``), ``page_size``/``num_pages``/``kv_dtype`` (paged
    knobs), ``spec`` (a ``serve.spec.SpecConfig`` or a bare ``Proposer``:
    speculative decoding, refused for 'R'/'M' stacks, whose carried state
    cannot roll back), ``capacity_factor`` (MoE configs only: expert
    buffers of ``ceil(cf * tokens * top_k / n_experts)`` rows, routes past
    them dropped to the residual path and counted in
    ``StepStats.expert_overflow``; None runs every expert on every token).
    The engine runs on the parameters' device and casts them to the
    compute dtype once (``models.model.compute_params``).
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        batch_slots: int,
        max_len: int,
        chunk_size: int = 16,
        token_budget: Optional[int] = None,
        max_queue: Optional[int] = None,
        packed: bool = False,
        cache: "str | KVCacheSpec" = "dense",
        page_size: int = 16,
        num_pages: Optional[int] = None,
        kv_dtype: Optional[str] = None,
        spec=None,
        dist=None,
        capacity_factor: Optional[float] = None,
    ):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {token_budget}")
        if isinstance(spec, Proposer):
            spec = SpecConfig(proposer=spec)
        self.spec = spec
        if spec is not None:
            if not isinstance(spec, SpecConfig):
                raise TypeError(f"spec must be a SpecConfig or a Proposer, got "
                                f"{type(spec).__name__}")
            spec.proposer.bind_engine(batch_slots, max_len)
        if dist is not None:
            raise UnsupportedDistError(
                "repro_torch serves on one device; a Distribution is not supported yet")
        require_chunkable(cfg, "ContinuousBatcher")
        if set(cfg.pattern) & {"R", "M"} and spec is not None:
            # raised here, not on the first rejected draft: trim_slot would
            # refuse mid-serve, stranding every in-flight request
            raise UnsupportedPatternError(
                "speculative decoding needs KV rollback of rejected drafts; recurrent "
                "state ('R'/'M' layers) has already consumed them and cannot roll back "
                "(see KVCache.trim_slot)")
        if capacity_factor is not None:  # ``scheduler.py:367-382``
            if cfg.n_experts <= 0:
                raise ValueError(
                    "capacity_factor is an MoE dispatch knob but the "
                    f"config has n_experts={cfg.n_experts}"
                )
            if not capacity_factor > 0:
                raise ValueError(f"capacity_factor must be > 0, got {capacity_factor}")
            # a step shape's expert buffers are sized once, from the config
            cfg = dataclasses.replace(cfg, capacity_factor=float(capacity_factor))
        self.moe_impl = "capacity" if capacity_factor is not None else "dense"
        if isinstance(cache, KVCacheSpec):
            kv_spec = cache
            if kv_spec.num_slots != batch_slots or kv_spec.max_len != max_len:
                raise ValueError(
                    f"KVCacheSpec(num_slots={kv_spec.num_slots}, "
                    f"max_len={kv_spec.max_len}) disagrees with the engine's "
                    f"batch_slots={batch_slots}, max_len={max_len}"
                )
        else:
            kv_spec = KVCacheSpec(
                num_slots=batch_slots, max_len=max_len, layout=cache,
                page_size=page_size, num_pages=num_pages, kv_dtype=kv_dtype,
            )
        self.packed = packed
        self.packed_capacity = (
            packing.packed_capacity(batch_slots, chunk_size, token_budget,
                                    draft_k=spec.k if spec is not None else 0)
            if packed else None
        )
        # pure-decode steps run a batch_slots-sized packed step
        self.packed_decode_capacity = batch_slots if packed else None
        self.params = compute_params(params, cfg)
        self.cfg = cfg
        self.recurrent = bool(set(cfg.pattern) & {"R", "M"})
        self.device = params_device(self.params)
        self.max_len = max_len
        self.chunk_size = chunk_size
        self.token_budget = token_budget
        self.max_queue = max_queue
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.kv: Optional[KVCache] = None
        if kv_spec.layout == "paged":
            self.kv = kv_spec.build(self.params, cfg)
            self.cache = self.kv.state
        else:
            self.cache = init_decode_cache(self.params, cfg, batch_slots, max_len,
                                           linear=True)
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self.cancelled: Dict[int, Request] = {}
        self.steps = 0
        self.step_stats: List[StepStats] = []
        self._shared_step = 0
        self._overflow_step = 0
        self._step_callbacks: List = []
        #: the attention kinds whose tile plans a paged step takes, in order
        self._plan_kinds = sorted(set(cfg.pattern) & {"G", "L"}) if self.kv is not None else []
        #: the step program, one CUDA graph per step shape on the card
        self.step_graph = StepGraph(self._program, self.device)

    # ------------------------------------------------------------------
    def add_step_callback(self, fn) -> None:
        """Register ``fn(stats: StepStats)`` to run at the end of every
        engine iteration, after its outputs and accounting are committed."""
        self._step_callbacks.append(fn)

    def validate_request(self, req: Request) -> None:
        """Reject a request the engine can never serve, without queueing it."""
        if not req.prompt:
            raise InvalidRequestError(
                f"request {req.uid}: empty prompt (decode needs at least "
                f"one prompt token to condition on)"
            )
        if req.max_new_tokens < 1:
            raise InvalidRequestError(
                f"request {req.uid}: max_new_tokens must be >= 1, got "
                f"{req.max_new_tokens}"
            )
        if not isinstance(req.sampling, SamplingParams):
            raise InvalidRequestError(
                f"request {req.uid}: sampling must be a SamplingParams, "
                f"got {type(req.sampling).__name__}"
            )
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise InvalidRequestError(
                f"request {req.uid} too long: {len(req.prompt)} prompt + "
                f"{req.max_new_tokens} new tokens > max_len {self.max_len}"
            )
        if self.kv is not None and self.kv.tables is not None:
            need = self.kv.tables.pages_required(len(req.prompt), req.max_new_tokens)
            if need > self.kv.num_pages:
                # admission is FIFO: an impossible request would livelock
                raise AdmissionError(
                    f"request references {need} pages at worst case but "
                    f"the pool has {self.kv.num_pages}; raise num_pages "
                    f"or split the request"
                )

    def submit(self, req: Request):
        self.validate_request(req)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            raise AdmissionError(
                f"queue full ({len(self.queue)}/{self.max_queue}); retry later"
            )
        if req.submitted_at is None:
            req.submitted_at = time.perf_counter()
        self.queue.append(req)

    def cancel(self, uid: int) -> bool:
        """Abort a request wherever it is (queued, prefilling, decoding),
        freeing its slot and pages.  True when the request was live."""
        now = time.perf_counter()
        for k, r in enumerate(self.queue):
            if r.uid == uid:
                self.queue.pop(k)
                r.cancelled = True
                r.finished_at = now
                self.cancelled[uid] = r
                return True
        for i, s in enumerate(self.slots):
            if s.req is not None and s.req.uid == uid:
                r = s.req
                s.req = None  # dense rows are position-masked; no scrub
                r.cancelled = True
                r.finished_at = now
                self.cancelled[uid] = r
                if self.kv is not None:
                    self.kv.free_slot(i)
                if self.spec is not None:
                    self.spec.proposer.free_slot(i)
                return True
        return False

    def _dedup_inflight_prefix(self, head: Request) -> bool:
        """Park ``head`` while an active slot is still prefilling a prompt
        whose shareable prefix pages ``head`` could map once written.  Never
        for recurrent patterns: no pages are ever published for them, so
        parking would wait on nothing."""
        if self.recurrent:
            return False
        ps = self.kv.page_size
        limit = (len(head.prompt) - 1) // ps  # head's shareable-block cap
        if limit == 0:
            return False
        best = 0
        for s in self.slots:
            if s.free or not s.prefilling:
                continue
            p = s.req.prompt
            m = 0
            n_common = min(len(head.prompt), len(p))
            while m < n_common and head.prompt[m] == p[m]:
                m += 1
            best = max(best, min(m // ps, limit))
        if best == 0:
            return False
        return best * ps > self.kv.probe_shared(head.prompt)

    def _admit(self):
        for i, s in enumerate(self.slots):
            if s.free and self.queue:
                shared = 0
                if self.kv is not None:
                    head = self.queue[0]
                    if self._dedup_inflight_prefix(head):
                        break  # park: FIFO, no skip-ahead
                    shared = self.kv.admit_slot(i, head.prompt, head.max_new_tokens)
                    if shared is None:
                        break  # the pool cannot guarantee the head yet
                elif self.recurrent:
                    # the dense layout has no KVCache.admit_slot: zero the
                    # recycled slot's recurrent rows here (carried state is
                    # read unmasked every step, unlike position-masked KV)
                    reset_recurrent_state(self.cache, [i])
                s.req = self.queue.pop(0)
                s.pos = shared  # shared prefix pages are already in the cache
                self._shared_step += shared
                s.req.admitted_step = self.steps
                s.req.admitted_at = time.perf_counter()

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(not s.free for s in self.slots)

    # ------------------------------------------------------------------
    def _propose(self) -> Dict[int, List[int]]:
        """Ask the proposer for drafts per decode slot, the ask clamped so a
        verify grant never writes past the slot (``max_len``) or emits past
        ``max_new_tokens`` (``scheduler.py:637-672``)."""
        if self.spec is None:
            return {}
        decode_slots = [i for i, s in enumerate(self.slots) if not s.free and not s.prefilling]
        # drafts come from the budget left after the decode baselines: no
        # proposer work for tokens the scheduler can never grant
        headroom = (self.spec.k if self.token_budget is None
                    else self.token_budget - len(decode_slots))
        if headroom <= 0:
            return {}
        asks = []
        for i in decode_slots:
            s = self.slots[i]
            r = s.req
            k = min(self.spec.k, headroom, r.max_new_tokens - len(r.output) - 1,
                    self.max_len - s.pos - 1)
            if k > 0:
                asks.append((i, r.prompt + r.output, k))
        if not asks:
            return {}
        drafts = self.spec.proposer.propose_batch(asks)
        # never trust a proposer to honour the clamp it was given
        return {i: list(drafts.get(i, ()))[:k] for i, _, k in asks}

    def _schedule(self, drafts: Dict[int, List[int]]) -> List[int]:
        """Per-slot token counts for this step under the budget: decode
        baselines first (unconditional), then draft tokens, then prefill
        chunks, both in admission order, until ``token_budget`` is spent;
        the oldest prefill always gets at least one token (starvation
        guard)."""
        n = [0] * len(self.slots)
        spent = 0
        prefill, decode = [], []
        for i, s in enumerate(self.slots):
            if s.free:
                continue
            if not s.prefilling:
                n[i] = 1
                spent += 1
                decode.append(i)
            else:
                prefill.append(i)

        def by_age(i):
            return self.slots[i].req.admitted_step, self.slots[i].req.uid

        for i in sorted(decode, key=by_age):
            want = len(drafts.get(i, ()))
            left = want if self.token_budget is None else self.token_budget - spent
            grant = min(want, max(left, 0))
            n[i] += grant
            spent += grant
        for rank, i in enumerate(sorted(prefill, key=by_age)):
            s = self.slots[i]
            want = min(self.chunk_size, len(s.req.prompt) - s.pos)
            left = want if self.token_budget is None else self.token_budget - spent
            grant = min(want, max(left, 0))
            if grant == 0 and rank == 0:
                grant = 1  # starvation guard (min_microbatches analogue)
            n[i] = grant
            spent += grant
        return n

    def _program(self, tokens, where, third, pick, *rest, mode: str = "greedy"):
        """One step from the embedding through the sampled tokens: a dense
        (B, C) step (``where`` the slots' positions, ``third`` their token
        counts) or a packed one (``where`` the slot ids, ``third`` the
        positions).  ``pick`` (R,) lists the flattened logits rows the step
        reads (``_picks``), which alone are sampled; ``rest`` the paged
        kernel's tile plans, one per attention kind, then, unless ``mode``
        is ``"greedy"``, the sampler's per-row seeds, output indices,
        temperatures, top-k and top-p of the R rows.  Returns (the sampled
        tokens, the step's dropped routes: a device scalar, 0 but in the
        capacity dispatch)."""
        step = packed_prefill if self.packed else prefill_chunk
        n_plans = len(self._plan_kinds)
        plans, sampler = rest[:n_plans], rest[n_plans:]
        logits, _, aux = step(self.params, self.cfg, self.cache, tokens, where, third,
                              plans=dict(zip(self._plan_kinds, plans)) if plans else None,
                              moe_impl=self.moe_impl, return_aux=True)
        rows = logits.reshape(-1, logits.shape[-1])[torch.as_tensor(pick, device=logits.device)]
        return sample_rows(rows, *(sampler or (None,) * 5), mode), aux["expert_overflow"]

    @property
    def _pick_rows(self) -> int:
        """R, the logits rows a step samples: one a slot (its last granted
        column), ``k + 1`` a slot with speculation (a verify grant's every
        column)."""
        return len(self.slots) * (self.spec.k + 1 if self.spec is not None else 1)

    def _picks(self, grants, first_row, out_idx):
        """The rows a step reads and their sampler inputs: for each grant,
        its last column (a prefill chunk's, which emits the slot's first
        token once the prompt is in) or, for a decode or verify grant, every
        column; ``first_row(i)`` is slot i's first row in the flattened
        logits and ``out_idx(i, j)`` its column j's output index.  Returns
        (pick (R,), {slot: [(column, position in pick)]}, the sampler's
        per-row host arrays (seeds, output indices, temperatures, top-k,
        top-p)); the rows past the needed ones repeat row 0 (greedy,
        discarded)."""
        r = self._pick_rows
        pick = np.zeros(r, np.int64)
        seeds, oidx = np.zeros(r, np.int64), np.zeros(r, np.int64)
        temps, topk, topp = np.zeros(r, np.float32), np.zeros(r, np.int64), np.ones(r, np.float32)
        where: Dict[int, List] = {}
        at = 0
        for i, _, toks in grants:
            cols = [len(toks) - 1] if self.slots[i].prefilling else range(len(toks))
            sp = self.slots[i].req.sampling
            where[i] = []
            for j in cols:
                pick[at] = first_row(i) + j
                seeds[at], oidx[at] = sp.seed & 0xFFFFFFFF, max(out_idx(i, j), 0)
                temps[at], topk[at], topp[at] = sp.temperature, sp.top_k, sp.top_p
                where[i].append((j, at))
                at += 1
        return pick, where, (seeds, oidx, temps, topk, topp)

    def _run(self, key, tokens, where, third, plans, grants, first_row, out_idx
             ) -> Dict[int, np.ndarray]:
        """Run the step program (its graph for ``key`` and the sampler's
        program on the card) and read its tokens back, which syncs the
        step.  Returns {slot: the grant's per-column tokens}: the columns the
        step reads (``_picks``) hold the sampled tokens, the others -1."""
        pick, at, sampler = self._picks(grants, first_row, out_idx)
        plans = [plans[k] for k in self._plan_kinds] if plans else []
        mode = sample_mode(*sampler[2:])
        extra = [] if mode == "greedy" else list(sampler)
        got, overflow = self.step_graph(key, tokens, where, third, pick, *plans, *extra,
                                        mode=mode)
        got = got.cpu().numpy()
        self._overflow_step = int(overflow)  # ``scheduler.py:788``
        out = {}
        for i, _, toks in grants:
            out[i] = np.full(len(toks), -1, np.int64)
            for j, a in at[i]:
                out[i][j] = got[a]
        return out

    def _run_dense(self, grants, out_base) -> Dict[int, np.ndarray]:
        """Dense (B, C) step; returns {slot: per-granted-column sampled
        tokens} (the last column the emitted or bonus token, a verify
        grant's earlier ones what the verifier checks drafts against).
        ``out_base`` maps a slot to the output index of its first column's
        prediction (negative mid-prefill: such a column is never read)."""
        b = len(self.slots)
        mixed = any(self.slots[i].prefilling for i, _, _ in grants)
        c = self.chunk_size if mixed else 1
        if self.spec is not None:
            # verify grants are up to 1 + k wide, folded into fixed widths
            c = max(c, self.spec.k + 1) if mixed else self.spec.k + 1
        tokens = np.zeros((b, c), np.int64)
        pos = np.zeros((b,), np.int64)
        lens = np.zeros((b,), np.int64)
        for i, pos0, toks in grants:
            tokens[i, : len(toks)] = toks
            pos[i] = pos0
            lens[i] = len(toks)
        return self._run((b, c), tokens, pos, lens, chunk_plans(self.cfg, self.cache, pos, lens, c),
                         grants, lambda i: i * c, lambda i, j: out_base[i] + j)

    def _run_packed(self, grants, out_base) -> Dict[int, np.ndarray]:
        """Token-packed (capacity,) step: pure-decode steps take the
        batch_slots-sized program, anything else (prefill, drafts) the mixed
        capacity.  Each row samples with its slot's params and its own
        output index (``PackedLayout.out_idx``), as the dense row of the
        same (request, output index) does."""
        capacity = self.packed_capacity
        if all(len(toks) == 1 for _, _, toks in grants):
            capacity = self.packed_decode_capacity
        layout = packing.pack_step(grants, capacity, out_base=out_base)
        slot_ids = layout.slot_ids.astype(np.int64)
        positions = layout.positions.astype(np.int64)
        return self._run(capacity, layout.tokens.astype(np.int64), slot_ids, positions,
                         packed_plans(self.cfg, self.cache, slot_ids, positions), grants,
                         lambda i: layout.spans[i][0],
                         lambda i, j: int(layout.out_idx[layout.spans[i][0] + j]))

    def step(self):
        """One engine iteration: mixed chunked-prefill + decode / verify."""
        t0 = time.perf_counter()
        queued0 = len(self.queue)
        self._shared_step = 0
        self._overflow_step = 0  # set by the step runner from the step's stats
        self._admit()
        if self.kv is not None:
            # lazy prefix sharing: an older request may have finished
            # writing pages this prompt can map since the last step
            for i, s in enumerate(self.slots):
                if not s.free and s.prefilling:
                    n_sh = self.kv.share(i, s.req.prompt, s.pos)
                    if n_sh:
                        s.pos += n_sh
                        self._shared_step += n_sh
        drafts = self._propose()
        n = self._schedule(drafts)
        decode_toks = prefill_toks = deferred = draft_toks = accepted_toks = 0
        grants: List[packing.Grant] = []  # (slot, start pos, tokens)
        granted_draft: Dict[int, List[int]] = {}
        # slot -> output index of the grant's first column's prediction:
        # column c at position pos + c predicts output pos + c + 1 -
        # len(prompt), the index the sampler's key folds in
        out_base: Dict[int, int] = {}
        for i, s in enumerate(self.slots):
            if s.free or n[i] == 0:
                if not s.free and s.prefilling:
                    deferred += min(self.chunk_size, len(s.req.prompt) - s.pos)
                continue
            r = s.req
            if s.prefilling:
                toks = r.prompt[s.pos : s.pos + n[i]]
                prefill_toks += n[i]
                deferred += max(min(self.chunk_size, len(r.prompt) - s.pos) - n[i], 0)
            else:
                # the budget may have cut the proposer's draft
                draft = drafts.get(i, [])[: n[i] - 1]
                granted_draft[i] = draft
                toks = [r.output[-1] if r.output else r.prompt[-1]] + draft
                decode_toks += 1
                draft_toks += len(draft)
            out_base[i] = s.pos + 1 - len(r.prompt)
            grants.append((i, s.pos, toks))

        if self.kv is not None:
            # allocate (and copy-on-write) every page the grants write,
            # then hand the refreshed block tables to the step
            self.kv.prepare_step(grants)
            self.cache = self.kv.state
        used_pages = self.kv.used_pages if self.kv is not None else 0

        sampled = (self._run_packed(grants, out_base) if self.packed
                   else self._run_dense(grants, out_base))
        if self.kv is not None:
            self.kv.state = self.cache

        now = time.perf_counter()
        for i, s in enumerate(self.slots):
            if s.free or n[i] == 0:
                continue
            r = s.req
            if s.prefilling:
                s.pos += n[i]
                if self.kv is not None:
                    self.kv.register_prompt_pages(i, r.prompt, s.pos)
                if s.pos < len(r.prompt):
                    continue  # still mid-prompt; no token emitted this step
                emitted = [int(sampled[i][n[i] - 1])]
            else:
                # verify: keep the draft prefix the target's per-column
                # samples confirm, plus the bonus token; roll back the rest
                accepted, emitted = accept_sampled(granted_draft[i], sampled[i])
                remaining = r.max_new_tokens - len(r.output)
                if len(emitted) > remaining:
                    # never stream past max_new_tokens; the request ends this
                    # step and free_slot reclaims the untrimmed tail
                    emitted = emitted[:remaining]
                    accepted = len(emitted) - 1
                    s.pos += 1 + accepted
                else:
                    s.pos += 1 + accepted
                    if self.kv is not None and accepted < len(granted_draft[i]):
                        self.kv.trim_slot(i, s.pos)
                accepted_toks += accepted
            r.output.extend(emitted)
            if r.first_token_at is None:
                r.first_token_at = now
                r.first_token_step = self.steps
            if r.done or s.pos >= self.max_len:
                r.truncated = not r.done
                r.finished_at = now
                self.finished[r.uid] = r
                s.req = None
                if self.kv is not None:
                    self.kv.free_slot(i)
                if self.spec is not None:
                    self.spec.proposer.free_slot(i)

        scheduled = decode_toks + draft_toks + prefill_toks
        stats = StepStats(
            self.steps, decode_toks, prefill_toks, deferred, now - t0,
            shared_tokens=self._shared_step,
            used_pages=used_pages,
            draft_tokens=draft_toks,
            accepted_tokens=accepted_toks,
            queued_requests=queued0,
            budget_overshoot=(
                max(scheduled - self.token_budget, 0)
                if self.token_budget is not None else 0
            ),
            expert_overflow=self._overflow_step,
        )
        self.step_stats.append(stats)
        self.steps += 1
        for fn in self._step_callbacks:
            fn(stats)

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        steps = 0
        while self.busy and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # ------------------------------------------------------------------
    def reset_stats(self):
        """Clear per-step and per-request accounting (e.g. after warmup)."""
        if self.busy:
            raise EngineStateError("reset_stats while requests are in flight")
        self.steps = 0
        self.step_stats = []
        self.finished = {}
        self.cancelled = {}
        self._shared_step = 0
        self._overflow_step = 0
        if self.kv is not None:
            self.kv.reset_accounting()

    def stats_summary(self) -> Dict[str, float]:
        """Aggregate engine + latency statistics (the reference's keys)."""
        st = self.step_stats
        done = list(self.finished.values())
        ttfts = [r.ttft for r in done if r.ttft is not None]

        def pct(values, q):
            return float(np.quantile(values, q)) if values else float("nan")

        def dist(prefix, values):
            return {
                f"mean_{prefix}": float(np.mean(values)) if values else float("nan"),
                f"p50_{prefix}": pct(values, 0.50),
                f"p99_{prefix}": pct(values, 0.99),
            }

        paged = (
            {
                "shared_tokens": float(sum(s.shared_tokens for s in st)),
                "peak_used_pages": float(max((s.used_pages for s in st), default=0)),
                "touched_pages": float(self.kv.tables.touched_pages),
                "num_pages": float(self.kv.num_pages),
            }
            if self.kv is not None
            else {}
        )
        n_draft = sum(s.draft_tokens for s in st)
        n_accept = sum(s.accepted_tokens for s in st)
        spec = (
            {
                "draft_tokens": float(n_draft),
                "accepted_tokens": float(n_accept),
                "acceptance_rate": n_accept / n_draft if n_draft else float("nan"),
            }
            if self.spec is not None
            else {}
        )
        generated = sum(len(r.output) for r in done)
        waits = [r.queue_wait for r in done if r.queue_wait is not None]
        admitted = [r.admitted_ttft for r in done if r.admitted_ttft is not None]
        return {
            **paged,
            **spec,
            "generated_tokens": float(generated),
            "steps_per_token": self.steps / generated if generated else float("nan"),
            "truncated": float(sum(r.truncated for r in done)),
            "cancelled": float(len(self.cancelled)),
            "steps": float(self.steps),
            "max_step_tokens": float(max((s.scheduled_tokens for s in st), default=0)),
            "mean_step_tokens": float(
                np.mean([s.scheduled_tokens for s in st]) if st else 0.0
            ),
            "budget_overshoot_tokens": float(sum(s.budget_overshoot for s in st)),
            "max_budget_overshoot": float(max((s.budget_overshoot for s in st), default=0)),
            "expert_overflow_tokens": float(sum(s.expert_overflow for s in st)),
            "max_expert_overflow": float(max((s.expert_overflow for s in st), default=0)),
            "mean_queued_requests": float(
                np.mean([s.queued_requests for s in st]) if st else 0.0
            ),
            "deferred_tokens": float(sum(s.deferred_tokens for s in st)),
            "max_step_wall": float(max((s.wall_time for s in st), default=0.0)),
            "finished": float(len(done)),
            "mean_ttft": float(np.mean(ttfts)) if ttfts else float("nan"),
            "p50_ttft": pct(ttfts, 0.50),
            "p99_ttft": pct(ttfts, 0.99),
            **dist("queue_wait", waits),
            **dist("admitted_ttft", admitted),
        }
