"""The capture-safe serving and training steps, on the CPU.

Each step of the port runs on the card as one captured CUDA graph
(``repro_torch.graphs.StepGraph``).  What makes a step capturable is held
here against the JAX package on seeded numpy inputs:

* the writes the reference's ``mode="drop"`` scatters discard (padding,
  positions past the buffer, blocks no page backs) go to the pools' spare
  row or spare page instead of being filtered out with a host sync: the
  caches and logits stay the reference's, and a spare filled with NaN is
  never read;
* K4's tile plan is padded with empty tiles to a row count the step's shape
  fixes (``step_plan_rows``): a numpy walk of the padded plan covers each
  token once over the unpadded plan's block range and gives the plain
  version's output;
* the engine, which makes those plans on the host, still serves the JAX
  engine's greedy streams, and a step given its plans reads nothing back
  from the device;
* ``StepGraph`` keys, static inputs, outputs and launch counters, with a
  stand-in for ``torch.cuda.CUDAGraph``; the persistent training buffers.

The graphs themselves run only on the card: ``test_torch_kernels_gpu.py``
holds graphed runs against eager ones under ``disable_graphs()``.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve import KVCacheSpec as JSpec  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import pack_step as jpack_step  # noqa: E402
from repro_torch import core, graphs  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention, ops, ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.serve import ContinuousBatcher, KVCacheSpec, Request, pack_step  # noqa: E402
from repro_torch.serve import scheduler  # noqa: E402
from repro_torch.serve import sampling  # noqa: E402
from test_torch_parity_util import assert_close, plan_scenario, walk_plan  # noqa: E402

torch.set_num_threads(1)

B, MAX_LEN, PAGE, CHUNK = 3, 24, 4, 8


def _pair(name):
    jc, tc = jget_smoke(name), get_smoke_config(name)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


@pytest.fixture(scope="module")
def qwen():
    return _pair("qwen2_5_3b")


@pytest.fixture(scope="module")
def mamba():
    return _pair("mamba2_130m")


# ---------------------------------------------------------------------------
# spare rows and pages: the reference's dropped writes
# ---------------------------------------------------------------------------

#: (slot, first position, tokens) per step.  Padding: slot 2 idle in the
#: first step, the chunked step's short rows.  Past the buffer: slot 1 from
#: position 20 on (MAX_LEN 24).  Unbacked blocks (paged): every slot writes
#: past the pages prepared for it (``PREPARED``).  Repeated slots: each
#: slot's tokens form one packed run.
DROP_STEPS = [
    [(0, 0, 8), (1, 20, 8)],
    [(0, 8, 5), (1, 4, 2), (2, 0, 8)],
    [(0, 13, 1), (1, 23, 3), (2, 8, 1)],
]
#: positions of each slot the paged steps prepare pages for
PREPARED = (12, 24, 6)


def _spare_leaves(data, layout):
    """The spare row (dense: past the slots' rows) or spare page of every
    attention pool leaf, one a layer."""
    stack = data["stack"]
    layers = [{k: x[g] for k, x in layer["attn"].items()}
              for layer in stack["groups"] for g in range(len(layer["attn"]["k"]))]
    layers += [layer["attn"] for layer in stack["tail"]]
    return [L.spare(x.flatten(0, 1) if layout == "dense" else x)[-1]
            for layer in layers for x in layer.values()]


def _drop_caches(jc, tc, jp, tp, layout, kv_dtype):
    if layout == "dense":
        return (jmodel.init_decode_cache(jp, jc, B, MAX_LEN, linear=True),
                model.init_decode_cache(tp, tc, B, MAX_LEN, linear=True), None, None)
    kw = dict(num_slots=B, max_len=MAX_LEN, layout="paged", page_size=PAGE, kv_dtype=kv_dtype)
    jkv, tkv = JSpec(**kw).build(jp, jc), KVCacheSpec(**kw).build(tp, tc)
    for s in range(B):
        prompt = list(range(100 + 30 * s, 130 + 30 * s))[:MAX_LEN - 1]
        assert jkv.admit_slot(s, prompt, 1) == tkv.admit_slot(s, prompt, 1) == 0
    grants = [(s, 0, [0] * n) for s, n in enumerate(PREPARED)]
    jkv.prepare_step(grants)
    tkv.prepare_step(grants)
    return jkv.state, tkv.state, jkv, tkv


@pytest.mark.parametrize("packed", [False, True], ids=["chunked", "packed"])
@pytest.mark.parametrize("layout,kv_dtype", [("dense", None), ("paged", None),
                                             ("paged", "int8")])
def test_dropped_writes_land_in_the_spare(qwen, layout, kv_dtype, packed):
    """Padding, positions past the buffer, blocks without a page and runs of
    one slot: logits and every visible cache row equal the JAX package's
    (whose scatters drop those writes); the dropped rows reached the spare
    (it changed), and a spare full of NaN is never read."""
    jc, tc, jp, tp = qwen
    jcache, tcache, jkv, tkv = _drop_caches(jc, tc, jp, tp, layout, kv_dtype)
    data = getattr(tcache, "data", tcache)
    spares = _spare_leaves(data, layout)
    for x in spares:  # NaN poisons any read (int8 codes through their NaN scales)
        x.fill_(float("nan") if x.dtype.is_floating_point else 127)
    if layout == "paged":
        assert int(tcache.tables.max()) <= tkv.num_pages  # the spare: the masked sentinel
    rng = np.random.default_rng(3)
    for step in DROP_STEPS:
        grants = [(s, p, rng.integers(0, jc.vocab_size, n).tolist()) for s, p, n in step]
        if packed:
            lay = jpack_step(grants, 24)
            jl, jcache = jmodel.packed_prefill(jp, jc, jcache, jnp.asarray(lay.tokens),
                                               jnp.asarray(lay.slot_ids),
                                               jnp.asarray(lay.positions))
            tl, tcache = model.packed_prefill(
                tp, tc, tcache, lay.tokens, lay.slot_ids, lay.positions,
                plans=model.packed_plans(tc, tcache, lay.slot_ids, lay.positions))
            tl, jl = tl[lay.slot_ids >= 0], np.asarray(jl)[lay.slot_ids >= 0]
        else:
            c = max(len(t) for _, _, t in grants)
            tokens, pos, lens = (np.zeros((B, c), np.int64), np.zeros(B, np.int64),
                                 np.zeros(B, np.int64))
            for s, p, t in grants:
                tokens[s, :len(t)], pos[s], lens[s] = t, p, len(t)
            jl, jcache = jmodel.prefill_chunk(jp, jc, jcache, jnp.asarray(tokens),
                                              jnp.asarray(pos), jnp.asarray(lens))
            tl, tcache = model.prefill_chunk(tp, tc, tcache, tokens, pos, lens,
                                             plans=model.chunk_plans(tc, tcache, pos, lens, c))
            valid = np.arange(c)[None, :] < lens[:, None]
            tl, jl = tl[torch.from_numpy(valid)], np.asarray(jl)[valid]
        assert bool(torch.isfinite(tl).all())
        assert_close(tl, jl, "model_f32")
    jleaves = [np.asarray(x) for x in jax.tree.leaves(getattr(jcache, "data", jcache))]
    tleaves = [x.float().numpy() for x in jax.tree.leaves(getattr(tcache, "data", tcache))]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert_close(b, a, "model_f32")
    assert all(bool(torch.isfinite(x).all()) for x in spares if x.dtype.is_floating_point)


# ---------------------------------------------------------------------------
# K4's padded tile plan
# ---------------------------------------------------------------------------

def _chunk_step(lens, c, start=(30, 3, 57, 0)):
    """The queries of an unpacked (B, C) step: slot i at ``start[i]`` on,
    its columns past ``lens[i]`` padding (``model.chunk_plans``' order)."""
    b = len(lens)
    offs = np.arange(c)
    q_pos = (np.asarray(start[:b])[:, None] + offs).reshape(-1)
    q_slots = np.where(offs[None] < np.asarray(lens)[:, None], np.arange(b)[:, None], -1)
    return q_pos, q_slots.reshape(-1), b, False


def _packed_step(grants, capacity):
    lay = pack_step(grants, capacity)
    return lay.positions, lay.slot_ids, 4, True


PADDED_STEPS = {
    "decode": _chunk_step([1, 1, 0, 1], 1),
    "mixed": _chunk_step([3, 8, 0, 17], 24),
    "packed": _packed_step([(0, 30, [1] * 9), (1, 3, [1]), (2, 57, [1] * 13)], 40),
    "padding_heavy": _packed_step([(3, 5, [1, 1])], 40),
}


def _scenario(q_pos, q_slots, num_slots=4, page_size=4, blocks=20, seed=0):
    """Pools, tables and queries of a step (qwen's group of 8 over 2 KV
    heads, head dim 16), every slot backed by its own pages."""
    rng = np.random.default_rng(seed)
    num_pages = num_slots * blocks
    tables = np.arange(num_pages, dtype=np.int32).reshape(blocks, num_slots).T.copy()
    return dict(q=rng.normal(size=(len(q_pos), 16, 16)).astype(np.float32),
                k_pool=rng.normal(size=(num_pages, page_size, 2, 16)).astype(np.float32),
                v_pool=rng.normal(size=(num_pages, page_size, 2, 16)).astype(np.float32),
                tables=tables, q_pos=np.asarray(q_pos, np.int32),
                q_slots=np.asarray(q_slots, np.int32))


@pytest.mark.parametrize("name", sorted(PADDED_STEPS))
@pytest.mark.parametrize("window", [0, 9])
def test_padded_plan_covers_each_token_once(name, window):
    """The padded plan has the step shape's row count; its first rows are
    the unpadded plan and the rest empty tiles (no tokens, slot -1, lo = hi
    = 0); each token lies in one tile, over the unpadded plan's range; the
    kernel's walk of it (its split set by the padded row count) gives the
    plain version's output."""
    q_pos, q_slots, batch, packed = PADDED_STEPS[name]
    rows = flash_attention.step_plan_rows(len(q_pos), batch, packed)
    a = _scenario(q_pos, q_slots)
    plain = flash_attention.paged_tile_plan(q_pos, q_slots, 4, 20, window)
    plan = flash_attention.paged_tile_plan(q_pos, q_slots, 4, 20, window, rows)
    assert plan.shape == (rows, flash_attention.PLAN_COLS) and plan.dtype == np.int32
    np.testing.assert_array_equal(plan[:len(plain)], plain)
    assert (plan[len(plain):] == [0, 0, -1, 0, 0]).all()
    assert len(plain) < rows or name == "decode"  # padding is exercised
    cover = {}
    for t0, n, slot, lo, hi in plan:
        for tok in range(t0, t0 + n):
            assert tok not in cover
            cover[tok] = (slot, lo, hi)
    assert sorted(cover) == list(range(len(q_pos)))
    for t0, n, slot, lo, hi in plain:
        assert all(cover[tok] == (slot, lo, hi) for tok in range(t0, t0 + n))
    got, walked = walk_plan(a, window=window, rows=rows)
    np.testing.assert_array_equal(walked, plan)
    want = ref.paged_attention_ref(**{k: torch.from_numpy(v) for k, v in a.items()},
                                   window=window)
    assert_close(got, want, "kernel_f32")
    np.testing.assert_array_equal(got[np.asarray(q_slots) < 0], 0.0)


@pytest.mark.parametrize("name,window", [("mixed", 0), ("mixed", 7), ("decode", 0),
                                         ("decode", 9)])
def test_walk_of_padded_plan_matches_plain_version(name, window):
    """The K4 plan scenarios a packed step can give (each slot one run),
    their plans padded to a packed step's rows."""
    a = plan_scenario(name)
    rows = flash_attention.step_plan_rows(len(a["q_pos"]), a["tables"].shape[0], True)
    got, plan = walk_plan(a, window=window, rows=rows)
    assert len(plan) == rows
    want = ref.paged_attention_ref(**{k: torch.from_numpy(np.asarray(v)) for k, v in a.items()},
                                   window=window)
    assert_close(got, want, "kernel_f32")


def test_plan_rows_bound_every_step():
    """``step_plan_rows`` bounds the tiles of every unpacked (B, C) step and
    every packed step of ``pack_step``, and is reached: a row of C = 64
    granting 3 tokens cuts into 1 + 8 tiles, one more than ceil(C / 8)."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        b, c = int(rng.integers(1, 9)), int(rng.choice([1, 8, 16, 64]))
        lens = rng.integers(0, c + 1, b)
        q_pos, q_slots, _, _ = _chunk_step(lens, c, start=(0,) * b)
        rows = flash_attention.step_plan_rows(b * c, b, False)
        assert len(flash_attention.paged_tile_plan(q_pos, q_slots, 16, 64)) <= rows
        slots = rng.permutation(8)[:int(rng.integers(1, 9))]
        grants = [(int(s), 0, [1] * int(rng.integers(1, 40))) for s in slots]
        cap = sum(len(t) for _, _, t in grants) + int(rng.integers(0, 20))
        lay = pack_step(grants, cap)
        rows = flash_attention.step_plan_rows(cap, 8, True)
        assert len(flash_attention.paged_tile_plan(lay.positions, lay.slot_ids, 16, 64)) <= rows
    q_pos, q_slots, _, _ = _chunk_step([3] * 8, 64, start=(0,) * 8)
    tiles = len(flash_attention.paged_tile_plan(q_pos, q_slots, 16, 64))
    assert tiles == flash_attention.step_plan_rows(8 * 64, 8, False) == 8 * 9


def test_overfull_plan_raises():
    q_pos, q_slots, _, _ = _chunk_step([3, 3], 64, start=(0, 0))
    with pytest.raises(ValueError, match="tiles"):
        flash_attention.paged_tile_plan(q_pos, q_slots, 16, 64, rows=10)


# ---------------------------------------------------------------------------
# the engine: host-made plans, the JAX engine's streams, nothing read back
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True], ids=["dense_step", "packed_step"])
def test_engine_plans_and_streams(qwen, monkeypatch, packed):
    """The paged engine hands every step its plans, padded to the step
    shape's row count, and serves the JAX engine's greedy streams."""
    jc, tc, jp, tp = qwen
    seen = []

    def spy(make):
        def wrapped(cfg, cache, *args):
            plans = make(cfg, cache, *args)
            seen.append(plans)
            return plans
        return wrapped

    monkeypatch.setattr(scheduler, "chunk_plans", spy(scheduler.chunk_plans))
    monkeypatch.setattr(scheduler, "packed_plans", spy(scheduler.packed_plans))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tc.vocab_size, n).tolist() for n in (3, 14, 6, 9, 1)]
    kw = dict(batch_slots=3, max_len=32, chunk_size=4, token_budget=6, cache="paged",
              page_size=4, packed=packed)
    outs = []
    for batcher, request, p, cfg in ((JBatcher, JRequest, jp, jc),
                                     (ContinuousBatcher, Request, tp, tc)):
        eng = batcher(p, cfg, **kw)
        for i, pr in enumerate(prompts):
            eng.submit(request(uid=i, prompt=list(pr), max_new_tokens=5))
        eng.run()
        outs.append({u: r.output for u, r in eng.finished.items()})
    assert outs[0] == outs[1] and len(outs[1]) == len(prompts)
    assert len(seen) == eng.steps
    shapes = ((eng.packed_capacity, eng.packed_decode_capacity) if packed else (3 * 4, 3 * 1))
    rows = {flash_attention.step_plan_rows(t, 3, packed) for t in shapes}
    assert all(len(plan) in rows for plans in seen for plan in plans.values())


@contextlib.contextmanager
def _no_reads_back(monkeypatch):
    """Every way a step could read a tensor back to the host raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("the step read the device back to the host")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "numpy", "cpu", "nonzero", "__bool__", "__int__"):
            m.setattr(torch.Tensor, name, refuse)
        m.setattr(torch, "nonzero", refuse)
        m.setattr(flash_attention, "tile_plan_tensor", refuse)
        yield


@pytest.mark.parametrize("family", ["qwen", "mamba"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("packed", [False, True], ids=["chunked", "packed"])
def test_step_reads_nothing_back(qwen, mamba, monkeypatch, family, layout, packed):
    """Given its inputs on the device and its plans, a serving step (the
    engine's step program, greedy and sampled with top-k and top-p) makes
    no host sync: no ``nonzero``, no copy back, no plan made from device
    tensors.  It samples the rows ``pick`` names, one a slot here."""
    jc, tc, jp, tp = qwen if family == "qwen" else mamba
    eng = ContinuousBatcher(tp, tc, batch_slots=B, max_len=MAX_LEN, chunk_size=CHUNK,
                            cache=layout, page_size=PAGE, packed=packed)
    grants = [(0, 0, [5] * 8), (2, 0, [7] * 3)]
    for s, _, t in grants:
        if eng.kv is not None:
            eng.kv.admit_slot(s, list(t) + [1], 2)
    if eng.kv is not None:
        eng.kv.prepare_step(grants)
        eng.cache = eng.kv.state
    if packed:
        lay = pack_step(grants, eng.packed_capacity)
        args = [lay.tokens, lay.slot_ids, lay.positions]
        plans = model.packed_plans(tc, eng.cache, lay.slot_ids, lay.positions)
    else:
        tokens = np.zeros((B, CHUNK), np.int64)
        tokens[0], tokens[2, :3] = 5, 7
        pos, lens = np.zeros(B, np.int64), np.asarray([8, 0, 3])
        args = [tokens, pos, lens]
        plans = model.chunk_plans(tc, eng.cache, pos, lens, CHUNK)
    args = [torch.as_tensor(np.asarray(x, np.int64)) for x in args]
    plans = [torch.from_numpy(plans[k]) for k in sorted(plans or {})]
    rows = eng._pick_rows
    pick = torch.arange(rows) * (1 if packed else CHUNK)
    sampler = sampling.sampler_inputs(np.arange(rows), np.arange(rows), np.full(rows, 0.8),
                                      np.full(rows, 5), np.full(rows, 0.9))
    with _no_reads_back(monkeypatch):
        out, overflow = eng._program(*args, pick, *plans)
        sampled, _ = eng._program(*args, pick, *plans, *sampler, mode="topk+topp")
    assert out.shape == sampled.shape == (rows,)
    assert int(overflow) == 0


# ---------------------------------------------------------------------------
# StepGraph, with a stand-in for torch.cuda.CUDAGraph
# ---------------------------------------------------------------------------


class FakeGraph:
    """Stands in for a captured ``torch.cuda.CUDAGraph``: a replay reruns
    the step on the static inputs it was captured over and writes the
    static outputs, calling no wrapper's counter (the card runs the kernels
    the capture recorded)."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs, self.replays = fn, outputs, 0

    def replay(self):
        before = ops.launch_counts(by_shape=True)
        new = self.fn()
        ops.add_launches({k: before.get(k, 0) - v
                          for k, v in ops.launch_counts(by_shape=True).items()})
        for o, n in zip(self.outputs, new if isinstance(new, tuple) else (new,)):
            o.copy_(n)
        self.replays += 1


class FakeCapture:
    """Stands in for ``graphs.CudaCapture``.  Like a CUDA capture it runs
    nothing: the wrappers' counting while PyTorch traces the step is
    played from what the warm-up counted, the static outputs are new
    tensors filled with the warm-up's."""

    def __init__(self, fail=False):
        self.warm_ups, self.graphs, self.fail = 0, [], fail

    def warm_up(self, fn):
        self.warm_ups += 1
        before = ops.launch_counts(by_shape=True)
        out = fn()
        self.counted = {k: v - before.get(k, 0)
                        for k, v in ops.launch_counts(by_shape=True).items()}
        return out

    def capture(self, fn, warm):
        ops.add_launches(self.counted)
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        out = tuple(w.clone() for w in warm)
        self.graphs.append(FakeGraph(fn, out))
        return self.graphs[-1], out, 0


def _counted_step(x, y):
    """A step of one 'kernel' (it counts an RMSNorm launch) and two outputs."""
    ops.KERNELS["rmsnorm"].launches += 1
    return x * 2 + y, x.sum()


def _step_graph(**kw):
    capture = FakeCapture(**kw)
    return graphs.StepGraph(_counted_step, "cpu", capture=capture), capture


def test_new_shape_new_graph_repeated_shape_new_inputs():
    sg, cap = _step_graph()
    a, b = np.arange(3.0), np.ones(3)
    out, total = sg((3,), a, b)
    assert torch.equal(out, torch.tensor([1.0, 3.0, 5.0])) and float(total) == 3.0
    out, total = sg((3,), a + 10, b)  # the same graph sees the new inputs
    assert torch.equal(out, torch.tensor([21.0, 23.0, 25.0])) and float(total) == 33.0
    sg((4,), np.zeros(4), np.zeros(4))
    assert len(cap.graphs) == 2 and cap.warm_ups == 2
    assert [g.replays for g in cap.graphs] == [1, 0]
    assert sg.keys == [(3,), (4,)]
    with pytest.raises(ValueError, match="shapes"):
        sg((3,), np.zeros(5), np.zeros(5))


def _scaled_step(x, *, scale):
    return x * scale


def test_static_arguments_pick_their_own_graph():
    """A keyword argument chooses the program, so the same shape key with
    another value captures another graph; a repeated value replays."""
    capture = FakeCapture()
    sg = graphs.StepGraph(_scaled_step, "cpu", capture=capture)
    assert torch.equal(sg((2,), np.ones(2), scale=2.0), torch.tensor([2.0, 2.0]))
    assert torch.equal(sg((2,), np.ones(2), scale=3.0), torch.tensor([3.0, 3.0]))
    assert torch.equal(sg((2,), np.full(2, 4.0), scale=2.0), torch.tensor([8.0, 8.0]))
    assert len(capture.graphs) == 2 and [g.replays for g in capture.graphs] == [1, 0]
    assert sg.keys == [((2,), (("scale", 2.0),)), ((2,), (("scale", 3.0),))]


def test_outputs_are_overwritten_by_the_next_replay():
    """Callers read (or copy) a step's outputs before the next one."""
    sg, _ = _step_graph()
    first, _ = sg((2,), np.ones(2), np.zeros(2))
    read = first.clone()
    second, _ = sg((2,), np.full(2, 5.0), np.zeros(2))
    assert second is first  # the graph's static output
    assert torch.equal(read, torch.tensor([2.0, 2.0]))
    assert torch.equal(first, torch.tensor([10.0, 10.0]))


def test_replays_count_the_captured_launches():
    ops.reset_launch_counts()
    sg, _ = _step_graph()
    for i in range(4):
        sg((2,), np.full(2, float(i)), np.zeros(2))
    assert ops.launch_counts()["rmsnorm"] == 4  # warm-up, then 3 replays; capture none


def _shaped_step(x):
    """A step of one K3 forward 'launch' at (B, Sq, Sk) = (2, 3, 5)."""
    fwd = ops.KERNELS["flash_attention"]
    fwd.launches += 1
    fwd.shapes[2, 3, 5] = fwd.shapes.get((2, 3, 5), 0) + 1
    return x + 1


def test_replays_count_the_captured_launches_by_shape():
    """The shape tally follows the kernel's count through capture and
    replays, and a reset clears it."""
    ops.reset_launch_counts()
    sg = graphs.StepGraph(_shaped_step, "cpu", capture=FakeCapture())
    for i in range(4):
        sg((2,), np.full(2, float(i)))
    counts = ops.launch_counts(by_shape=True)
    assert counts["flash_attention"] == 4 and counts["flash_attention", (2, 3, 5)] == 4
    assert ops.launch_counts() == {**{k: 0 for k in ops.KERNELS}, "flash_attention": 4}
    ops.reset_launch_counts()
    assert not ops.KERNELS["flash_attention"].shapes


def test_skipped_input_copy_gives_stale_outputs(monkeypatch):
    """The planted fault ``chip_smoke.py`` must catch: a replay whose input
    copy is skipped computes on the previous inputs."""
    sg, _ = _step_graph()
    sg((2,), np.ones(2), np.zeros(2))
    monkeypatch.setattr(graphs.StepGraph, "load_inputs", lambda self, static, inputs: None)
    out, _ = sg((2,), np.full(2, 7.0), np.zeros(2))
    assert torch.equal(out, torch.tensor([2.0, 2.0]))


def test_disabled_and_cpu_steps_run_eagerly():
    sg, cap = _step_graph()
    with graphs.disable_graphs():
        assert not graphs.graphs_enabled()
        out, _ = sg((2,), torch.ones(2), torch.zeros(2))
    assert graphs.graphs_enabled()
    assert torch.equal(out, torch.tensor([2.0, 2.0])) and cap.warm_ups == 0
    plain = graphs.StepGraph(_counted_step, "cpu")
    out, _ = plain((2,), torch.ones(2), torch.ones(2))
    assert torch.equal(out, torch.tensor([3.0, 3.0])) and plain.keys == []


def test_capture_failure_raises_typed_and_restores_counters():
    ops.reset_launch_counts()
    sg, _ = _step_graph(fail=True)
    with pytest.raises(graphs.GraphCaptureError, match="capturing"):
        sg((2,), np.ones(2), np.zeros(2))
    assert ops.launch_counts()["rmsnorm"] == 1  # the warm-up ran; the failed capture did not
    assert sg.keys == []


# ---------------------------------------------------------------------------
# persistent training buffers
# ---------------------------------------------------------------------------


def test_accumulator_is_persistent_and_zeroed(qwen):
    """The engines keep one accumulator (one graph a micro-batch shape on
    the card) across steps: the same tensors, zeroed in place, the same
    sums as a fresh accumulator's."""
    jc, tc, jp, tp = qwen
    rng = np.random.default_rng(5)
    mbs = {"tokens": torch.from_numpy(rng.integers(0, tc.vocab_size, (3, 1, 16))),
           "weights": torch.ones((3, 1, 16))}
    grad = core.make_grad_fn(lambda p, mb: model.loss_fn(p, tc, mb))
    eng = core.InGraphEngine(grad, core.DropConfig(tau=0.8))
    g1, l1, _ = eng.step(tp, mbs, np.asarray([0.4, 0.3, 0.5]))
    first = [x.clone() for x in tree_leaves(g1)]
    g2, l2, _ = eng.step(tp, mbs, np.asarray([0.4, 0.3, 0.5]))
    assert all(a is b for a, b in zip(tree_leaves(g1), tree_leaves(g2)))
    assert all(torch.equal(a, b) for a, b in zip(first, tree_leaves(g2)))
    assert torch.equal(l1, l2)
    fresh, _, _ = core.accumulate_grads(grad, tp, mbs, [1, 1, 0], core.DropConfig())
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(fresh), tree_leaves(g2)))


def test_compute_copy_is_refilled_in_place(qwen):
    _, tc, _, tp = qwen
    cfg = dataclasses.replace(tc, dtype="bfloat16")
    params = {k: v for k, v in model.init_params(cfg, seed=1, device="cpu").items()}
    compute = model.train_params(params, cfg)
    before = [x.data_ptr() for x in tree_leaves(compute)]
    for x in tree_leaves(params):
        x.mul_(1.5)
    again = model.train_params(params, cfg, out=compute)
    assert again is compute and [x.data_ptr() for x in tree_leaves(compute)] == before
    for a, b in zip(tree_leaves(compute), tree_leaves(model.train_params(params, cfg))):
        assert torch.equal(a, b)
