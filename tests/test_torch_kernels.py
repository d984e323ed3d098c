"""The port's kernels: plain versions against the JAX references on the CPU,
and device dispatch.  The CUDA/Triton kernels themselves are held to their
plain versions on the card by ``test_torch_kernels_gpu.py``.

Mirrors ``tests/test_kernels.py``: paged attention with windows, softcap,
int8 scales, hostile block tables, padding and fully masked queries
(:140-340); RMSNorm in the kernel's f32 mode and in ``apply_norm``'s mode
(:343-355); training flash attention against the interpret-mode Pallas
kernel (:17-138) and its backward against ``jax.grad`` of ``layers.sdpa``
and ``layers.sdpa_flash``; the RMSNorm backward against ``jax.grad`` of
``apply_norm``; masked accumulation against the interpret-mode kernel
(:357-380); the SSD intra-chunk (K6) and segment-masked (K5) terms against
the interpret-mode Pallas kernels and the reference's oracles
(``tests/test_ssd_kernel.py``).  Inputs are made with numpy from a seed
and fed to both packages.  Beside them, the schedules the CUDA kernels
read: K3's ``tile_plan``, K4's ``paged_tile_plan`` (with a numpy walk of
the paged kernel's schedule held to the plain version), K2 forward's
``fwd_partition`` (with a numpy walk of its stage ring held to the plain
version) and its backward's row and column partition, and the SSD
kernels' ``ssd_plan`` (with a numpy walk of K6's and K5's schedule held
to the plain versions).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ModelConfig as JConfig  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels import flash_attention, masked_accum, ops, ref, rmsnorm  # noqa: E402
from repro_torch.kernels import ssd_chunk  # noqa: E402
from test_torch_parity_util import (  # noqa: E402
    BF16_ULPS,
    K2_INV_TIE,
    K3_ROW_TOL,
    TOL,
    assert_close,
    bf16_ulps,
    dscale_without_rows,
    packed_scenario,
    plan_scenario,
    quantize_pool,
    rmsnorm_model_ulps,
    rmsnorm_without_last_vector,
    row_rel_err,
    skip_diagonal_tile_mask,
    skip_last_page,
    ssd_chunk_inputs,
    ssd_segment_inputs,
    ssd_skip_diagonal_tile_mask,
    walk_plan,
)

torch.set_num_threads(1)


def run_both(a, **kw):
    """(JAX reference, the port's plain version) on the same inputs."""
    want = jref.paged_attention_ref(**{k: jnp.asarray(v) for k, v in a.items()}, **kw)
    ta = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    return np.asarray(want), ref.paged_attention_ref(**ta, **kw).numpy()


class TestPagedAttentionPlain:
    @pytest.mark.parametrize("g", [1, 2, 4])
    @pytest.mark.parametrize("page_size", [4, 16])
    @pytest.mark.parametrize("window", [0, 7])
    def test_matches_jax_ref(self, g, page_size, window):
        a = packed_scenario(page_size=page_size, kvh=2, h=2 * g, seed=g + page_size)
        want, plain = run_both(a, window=window)
        assert_close(plain, want, "kernel_f32")

    @pytest.mark.parametrize("softcap", [2.0, 30.0])
    def test_softcap(self, softcap):
        a = packed_scenario(seed=5)
        want, plain = run_both(a, softcap=softcap, window=5)
        assert_close(plain, want, "kernel_f32")
        _, no_cap = run_both(a, window=5)
        assert np.abs(no_cap - plain).max() > 1e-3  # the cap is load-bearing

    def test_int8_scales(self):
        a = packed_scenario(seed=11)
        a["k_pool"], a["k_scale"] = quantize_pool(a["k_pool"])
        a["v_pool"], a["v_scale"] = quantize_pool(a["v_pool"])
        want, plain = run_both(a)
        assert_close(plain, want, "kernel_f32")

    @pytest.mark.parametrize("window", [0, 7])
    @pytest.mark.parametrize("int8", [False, True])
    def test_recurrentgemma_shape(self, window, int8):
        """(head dim 256, group 10), the (256, 10) instance's: 10 heads on one
        KV head, with the window and int8 pages."""
        a = packed_scenario(page_size=16, kvh=1, h=10, d=256, seed=24, lens=(40, 9, 33))
        if int8:
            a["k_pool"], a["k_scale"] = quantize_pool(a["k_pool"])
            a["v_pool"], a["v_scale"] = quantize_pool(a["v_pool"])
        want, plain = run_both(a, window=window, softcap=5.0 if window else 0.0)
        assert plain.shape == (len(a["q_pos"]), 10, 256)
        assert_close(plain, want, "kernel_f32")

    def test_hostile_tables(self):
        """Negative and >= num_pages entries mask their block (never wrap
        into another slot's pages); a slot whose every block is hostile
        gives exact zeros."""
        a = packed_scenario(seed=13)
        num_pages = a["k_pool"].shape[0]
        a["tables"][0, 0] = -3
        a["tables"][1, 1] = num_pages + 5
        a["tables"][2, :] = -1
        want, plain = run_both(a)
        assert_close(plain, want, "kernel_f32")
        masked = a["q_slots"] == 2
        assert (plain[masked] == 0).all()
        assert (want[masked] == 0).all()

    def test_padding_query_is_zero(self):
        a = packed_scenario(seed=3)
        a["q_slots"][[0, 3]] = -1
        want, plain = run_both(a)
        assert_close(plain, want, "kernel_f32")
        np.testing.assert_array_equal(plain[[0, 3]], 0.0)

    def test_no_cross_page_leak(self):
        """Poison every page slot 0 does not own: its queries must not move."""
        a = packed_scenario(seed=4)
        _, clean = run_both(a)
        own = {int(p) for p in a["tables"][0] if p < a["k_pool"].shape[0]}
        poison = [p for p in range(a["k_pool"].shape[0]) if p not in own]
        a["v_pool"][poison] += 1e4
        _, plain = run_both(a)
        sel = a["q_slots"] == 0
        np.testing.assert_array_equal(plain[sel], clean[sel])

    def test_bf16_inputs_round_once(self):
        """bf16 queries and pools: f32 math, the output rounded to bf16."""
        a = packed_scenario(seed=21)
        ta = {k: torch.from_numpy(v) for k, v in a.items()}
        for k in ("q", "k_pool", "v_pool"):
            ta[k] = ta[k].to(torch.bfloat16)
        out = ref.paged_attention_ref(**ta)
        assert out.dtype == torch.bfloat16
        want = ref.paged_attention_ref(**{k: (v.float() if v.is_floating_point() else v)
                                          for k, v in ta.items()})
        assert bf16_ulps(out, want.to(torch.bfloat16)) == 0

    def test_half_passed_scales_raise(self):
        a = packed_scenario(seed=1)
        ta = {k: torch.from_numpy(v) for k, v in a.items()}
        with pytest.raises(ValueError, match="k_scale and v_scale"):
            ref.paged_attention_ref(**ta, k_scale=torch.ones(ta["k_pool"].shape[:3]))


class TestRmsnormPlain:
    @pytest.mark.parametrize("shape", [(4, 128), (3, 17, 256), (1, 1, 1024), (513, 128)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_ref_matches_jax_kernel_ref(self, shape, dtype):
        rng = np.random.default_rng(sum(shape))
        x = rng.normal(size=shape).astype(np.float32)
        s = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
        want = jref.rmsnorm_ref(jnp.asarray(x, dtype), jnp.asarray(s))
        got = ref.rmsnorm_ref(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(s))
        if dtype == "float32":
            assert_close(got, want, "norm_f32")
        else:
            assert bf16_ulps(got, want) <= BF16_ULPS

    @pytest.mark.parametrize("shape", [(4, 128), (2, 9, 256), (513, 64)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_model_mode_matches_apply_norm(self, shape, dtype):
        rng = np.random.default_rng(7 + sum(shape))
        x = (3 * rng.normal(size=shape)).astype(np.float32)
        s = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
        cfg = JConfig(d_model=shape[-1], dtype=dtype)
        want = jlayers.apply_norm({"scale": jnp.asarray(s)}, jnp.asarray(x, dtype), cfg)
        got = ref.rmsnorm_model(torch.from_numpy(x).to(getattr(torch, dtype)),
                                torch.from_numpy(s))
        if dtype == "float32":
            assert_close(got, want, "norm_f32")
        else:
            assert bf16_ulps(got, want) <= BF16_ULPS

    def test_model_mode_differs_from_kernel_mode_in_bf16(self):
        """The reason the port needs both modes: rounding ``inv`` first
        changes bf16 results, not f32 ones."""
        rng = np.random.default_rng(0)
        x = torch.from_numpy((3 * rng.normal(size=(64, 256))).astype(np.float32))
        s = torch.from_numpy((1 + 0.1 * rng.normal(size=256)).astype(np.float32))
        assert torch.equal(ref.rmsnorm_model(x, s), ref.rmsnorm_ref(x, s))
        xb = x.to(torch.bfloat16)
        assert not torch.equal(ref.rmsnorm_model(xb, s), ref.rmsnorm_ref(xb, s))


class TestDispatch:
    def test_cpu_tensors_take_the_plain_path_uncounted(self):
        ops.reset_launch_counts()
        a = packed_scenario(seed=2)
        ta = {k: torch.from_numpy(v) for k, v in a.items()}
        got = ops.paged_flash_attention(**ta, window=3)
        np.testing.assert_array_equal(got.numpy(),
                                      ref.paged_attention_ref(**ta, window=3).numpy())
        x = torch.randn(5, 64, dtype=torch.bfloat16)
        s = torch.ones(64)
        assert torch.equal(ops.rmsnorm(x, s, model=True), ref.rmsnorm_model(x, s))
        assert torch.equal(ops.rmsnorm(x, s), ref.rmsnorm_ref(x, s))
        q, k, v = torch.randn(1, 4, 8, 16), torch.randn(1, 2, 8, 16), torch.randn(1, 2, 8, 16)
        assert torch.equal(ops.flash_attention(q, k, v), ref.flash_attention_fwd_ref(q, k, v)[0])
        acc, g = torch.randn(6), torch.randn(6)
        want = ref.masked_accum_ref(acc, g, 1.0, 0.5)
        assert torch.equal(ops.masked_accum(acc, g, 1.0, 0.5), want) and torch.equal(acc, want)
        x, dt, cum, b, c = (torch.from_numpy(v) for v in ssd_chunk_inputs(1, 2, 8, 2, 4, 3, 0))
        assert torch.equal(ops.ssd_chunk(x, dt, cum, b, c), ref.ssd_chunk_ref(x, dt, cum, b, c))
        seg = torch.tensor([0] * 5 + [1] * 9 + [-1] * 2)
        args = (x.reshape(16, 2, 4), dt.reshape(16, 2), cum.reshape(16, 2), b.reshape(16, 3),
                c.reshape(16, 3), seg)
        assert torch.equal(ops.ssd_segment(*args), ref.ssd_segment_ref(*args))
        counts = ops.launch_counts()
        assert set(counts) == {"paged_attention", "rmsnorm", "rmsnorm_bwd", "flash_attention",
                               "flash_attention_bwd", "masked_accum", "ssd_chunk",
                               "ssd_chunk_bwd", "ssd_segment"}
        assert all(n == 0 for n in counts.values()), counts

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        a = {k: torch.from_numpy(v) for k, v in packed_scenario(seed=2).items()}
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention.paged_flash_attention(**a)
        with pytest.raises(ValueError, match="CUDA"):
            rmsnorm.rmsnorm(torch.ones(2, 8), torch.ones(8))
        with pytest.raises(ValueError, match="CUDA"):
            rmsnorm.rmsnorm_bwd(torch.ones(2, 8), torch.ones(8), torch.ones(2, 8))
        q = torch.ones(1, 16, 128, 128, dtype=torch.bfloat16)
        kv = torch.ones(1, 2, 128, 128, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention.flash_attention_fwd(q, kv, kv)
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention.flash_attention_bwd(q, kv, kv, q, torch.ones(1, 16, 128), q)
        with pytest.raises(ValueError, match="CUDA"):
            masked_accum.masked_accum(torch.ones(4), torch.ones(4), 1.0)
        x, dt, cum, b, c = (torch.from_numpy(v) for v in ssd_chunk_inputs(1, 1, 64, 2, 64, 128, 0))
        with pytest.raises(ValueError, match="CUDA"):
            ssd_chunk.ssd_chunk(x, dt, cum, b, c)
        with pytest.raises(ValueError, match="CUDA"):
            ssd_chunk.ssd_segment(x[0, 0], dt[0, 0], cum[0, 0], b[0, 0], c[0, 0],
                                  torch.zeros(64, dtype=torch.int32))

    def test_other_devices_raise(self):
        x = torch.ones(2, 8, device="meta")
        with pytest.raises(ValueError, match="no kernel or plain path"):
            ops.rmsnorm(x, torch.ones(8, device="meta"))

    def test_cuda_without_a_gpu_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
        assert resolve_device("cpu").type == "cpu"

    @pytest.mark.parametrize("ctas,num_blocks,sms,want", [
        (16, 34, 132, (9, 4)),  # decode at 8 slots: split, >= 4 blocks a split
        (520, 34, 132, (1, 34)),  # a prefill-sized grid runs unsplit
        (222, 34, 132, (2, 17)),
        (2, 3, 132, (1, 3)),  # fewer blocks than warps: nothing to split
        (1, 1000, 132, (250, 4)),
    ])
    def test_split_blocks(self, ctas, num_blocks, sms, want):
        splits, per = flash_attention.split_blocks(ctas, num_blocks, sms)
        assert (splits, per) == want
        assert splits * per >= num_blocks > (splits - 1) * per  # no empty tail split

    @pytest.mark.parametrize("groups,length,want", [
        (8, 256, 4),  # K6 at B 8, L 256: 768 CTAs of 4 heads
        (8, 64, 4),  # K6 at B 8, L 64 (a 64-token step): 192 CTAs of 4 heads
        (8, 16, 1),  # K6 at B 8, L 16 (a decode step): 192 CTAs of one head
        (1, 257, 2),  # K5 at T 257: 204 CTAs of 2 heads
        (1, 8, 1),  # K5 at T 8: 24 CTAs, every (row tile, head) its own
        (2, 17, 1),  # a 17-row step: 96 CTAs of one head
    ])
    def test_ssd_heads_per_cta(self, groups, length, want):
        """``ssd_plan`` at the serving shapes (24 heads, 132 SMs): its heads
        a CTA; every (chunk, 16-row query tile, head) in exactly one CTA;
        the last row tile (the most key tiles) first; the grid gives each SM
        a CTA wherever the step has that many (row tile, head) units."""
        heads, sms = 24, 132
        plan = ssd_chunk.ssd_plan(groups, length, heads, sms)
        assert plan.heads == want and want in ssd_chunk.HEAD_GROUPS
        seen = []
        for cta in range(plan.ctas):
            g, r, h0 = plan.work(cta)
            seen += [(g, r, h) for h in range(h0, min(h0 + plan.heads, heads))]
        tiles = -(-length // ssd_chunk.ROW_TILE)
        want_units = {(g, t * ssd_chunk.ROW_TILE, h)
                      for g in range(groups) for t in range(tiles) for h in range(heads)}
        assert sorted(seen) == sorted(want_units)  # each exactly once
        rows = [plan.work(c)[1] for c in range(plan.ctas)]
        assert rows == sorted(rows, reverse=True)  # the most key tiles first
        assert plan.ctas >= min(sms, len(want_units))

    def test_ssd_refuses_unbuilt_shapes(self):
        ssd_chunk.require_built(128, 64)
        for n, p, dtype in ((16, 64, torch.float32), (128, 32, torch.float32),
                            (128, 64, torch.bfloat16)):
            with pytest.raises(ssd_chunk.UnbuiltShapeError):
                ssd_chunk.require_built(n, p, dtype)


# ---------------------------------------------------------------------------
# K4's tile plan and a numpy walk of it; K2 backward's partition
# ---------------------------------------------------------------------------


def jax_block_range(pos, slot, page_size, num_blocks, window):
    """[lo, hi) of one query by ``_paged_attn_kernel``'s formula
    (src/repro/kernels/flash_attention.py:184-188), in Python ints."""
    hi = min(pos // page_size + 1, num_blocks) if slot >= 0 else 0
    lo = max((pos - window + 1) // page_size, 0) if window > 0 else 0
    return lo, hi


PLAN_CASES = [("mixed", 0), ("mixed", 7), ("mixed", 100), ("decode", 0), ("decode", 9),
              ("hostile_tables", 0), ("padding", 5), ("fully_masked", 0), ("interleaved", 0),
              ("interleaved", 6)]


class TestPagedTilePlan:
    @pytest.mark.parametrize("name,window", PLAN_CASES)
    def test_tiles_partition_the_tokens(self, name, window):
        """Every token (so every (token, head) row) lies in exactly one tile;
        a tile is a run of at most TILE_TOKENS consecutive tokens of one
        slot; its block range is the union of its tokens' [lo, hi) by the
        JAX formula; the longest range comes first."""
        a = plan_scenario(name)
        ps, nb = a["k_pool"].shape[1], a["tables"].shape[1]
        plan = flash_attention.paged_tile_plan(a["q_pos"], a["q_slots"], ps, nb, window)
        assert plan.dtype == np.int32 and plan.shape[1] == flash_attention.PLAN_COLS
        seen = np.zeros(len(a["q_pos"]), int)
        for t0, n, slot, lo, hi in plan:
            assert 1 <= n <= flash_attention.TILE_TOKENS
            seen[t0:t0 + n] += 1
            assert (a["q_slots"][t0:t0 + n] == slot).all()
            blocks = set()
            for tok in range(t0, t0 + n):
                tlo, thi = jax_block_range(int(a["q_pos"][tok]), slot, ps, nb, window)
                blocks |= set(range(tlo, thi))
            assert set(range(lo, hi)) == blocks
        assert (seen == 1).all()
        lengths = plan[:, 4] - plan[:, 3]
        assert (np.diff(lengths) <= 0).all()

    def test_tables_do_not_change_the_plan(self):
        """Bad entries are masked by the kernel, not planned around."""
        a, b = plan_scenario("mixed"), plan_scenario("fully_masked")
        args = (4, a["tables"].shape[1], 3)
        np.testing.assert_array_equal(
            flash_attention.paged_tile_plan(a["q_pos"], a["q_slots"], *args),
            flash_attention.paged_tile_plan(b["q_pos"], b["q_slots"], *args))

    def test_runs_are_cut_into_tiles(self):
        assert flash_attention.TILE_TOKENS == 8
        pos = np.r_[np.arange(100, 164), 300, np.arange(9), -1, -1]
        slots = np.r_[[0] * 64, 1, [2] * 9, -1, -1]
        plan = flash_attention.paged_tile_plan(pos, slots, 16, 34)
        got = sorted(map(tuple, plan[:, :3].tolist()))
        assert got == [(t, 8, 0) for t in range(0, 64, 8)] + [(64, 1, 1), (65, 8, 2),
                                                              (73, 1, 2), (74, 2, -1)]
        assert plan[plan[:, 2] < 0, 3:].tolist() == [[0, 0]]  # padding: an empty range
        assert tuple(plan[0]) == (64, 1, 1, 0, 19)  # the longest range first

    def test_tensor_plan_is_the_numpy_plan(self):
        a = plan_scenario("padding")
        got = flash_attention.tile_plan_tensor(torch.from_numpy(a["q_pos"]),
                                               torch.from_numpy(a["q_slots"]), 4, 11, 5)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), flash_attention.paged_tile_plan(
            a["q_pos"], a["q_slots"], 4, 11, 5))

    @pytest.mark.parametrize("name,window", PLAN_CASES)
    @pytest.mark.parametrize("int8", [False, True])
    def test_walk_matches_plain_version(self, name, window, int8):
        """The plan's walk (tiles, splits, 64-key stages, 16-key chunks dealt
        to warps, online softmax, the warps' and the splits' merges) gives
        ``ref.paged_attention_ref``'s output; padding and fully masked
        queries exact zeros."""
        a = plan_scenario(name)
        if int8:
            a["k_pool"], a["k_scale"] = quantize_pool(a["k_pool"])
            a["v_pool"], a["v_scale"] = quantize_pool(a["v_pool"])
        softcap = 5.0 if window == 7 else 0.0
        got, plan = walk_plan(a, window=window, softcap=softcap)
        ta = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
        want = ref.paged_attention_ref(**ta, window=window, softcap=softcap).numpy()
        assert_close(got, want, "kernel_f32")
        zero = a["q_slots"] < 0
        if name == "fully_masked":
            zero |= a["q_slots"] == 2
        np.testing.assert_array_equal(got[zero], 0.0)
        if name == "decode":
            splits, _ = flash_attention.split_blocks(len(plan) * 2, a["tables"].shape[1], 132)
            assert splits > 1  # the split merge is exercised

    @pytest.mark.parametrize("name,window", PLAN_CASES)
    @pytest.mark.parametrize("int8", [False, True])
    def test_walk_of_the_d256_g10_instance(self, name, window, int8):
        """The (256, 10) instance's schedule (tiles of 4 tokens, a warp a
        token, 32-key stages of two chunks, two CTAs an SM for the split),
        walked over 10 heads on one KV head, gives the plain version's
        output; padding and fully masked queries exact zeros."""
        inst = flash_attention.INSTANCES[256, 10]
        a = plan_scenario(name, kvh=1, h=10, d=32)
        if int8:
            a["k_pool"], a["k_scale"] = quantize_pool(a["k_pool"])
            a["v_pool"], a["v_scale"] = quantize_pool(a["v_pool"])
        softcap = 5.0 if window == 7 else 0.0
        got, plan = walk_plan(a, window=window, softcap=softcap, inst=inst)
        assert 1 <= plan[:, 1].min() and plan[:, 1].max() <= inst.tile_tokens == 4
        ta = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
        want = ref.paged_attention_ref(**ta, window=window, softcap=softcap).numpy()
        assert_close(got, want, "kernel_f32")
        zero = a["q_slots"] < 0
        if name == "fully_masked":
            zero |= a["q_slots"] == 2
        np.testing.assert_array_equal(got[zero], 0.0)
        if name == "decode":
            splits, _ = flash_attention.split_blocks(len(plan), a["tables"].shape[1], 132,
                                                     inst.ctas_per_sm)
            assert splits > 1  # the split merge is exercised

    @pytest.mark.parametrize("name,window", PLAN_CASES)
    @pytest.mark.parametrize("kvh,h", [(4, 8), (1, 9)], ids=["g2", "g9"])
    def test_walk_of_the_g2_and_g9_instances(self, name, window, kvh, h):
        """The (128, 2) instance's schedule (tiles of 8 tokens, two a warp,
        three CTAs an SM) over 4 KV heads of 2 queries, and the (128, 9)
        one's (tiles of 4, a warp a token, 64-key stages, two CTAs an SM)
        over one KV head of 9, walked at head dim 32, give the plain
        version's output; padding and fully masked queries exact zeros."""
        inst = flash_attention.INSTANCES[128, h // kvh]
        a = plan_scenario(name, kvh=kvh, h=h, d=32)
        softcap = 5.0 if window == 7 else 0.0
        got, plan = walk_plan(a, window=window, softcap=softcap, inst=inst)
        assert 1 <= plan[:, 1].min() and plan[:, 1].max() <= inst.tile_tokens
        ta = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
        want = ref.paged_attention_ref(**ta, window=window, softcap=softcap).numpy()
        assert_close(got, want, "kernel_f32")
        zero = a["q_slots"] < 0
        if name == "fully_masked":
            zero |= a["q_slots"] == 2
        np.testing.assert_array_equal(got[zero], 0.0)
        if name == "decode":
            splits, _ = flash_attention.split_blocks(len(plan) * kvh, a["tables"].shape[1], 132,
                                                     inst.ctas_per_sm)
            assert splits > 1  # the split merge is exercised

    def test_instances(self):
        """The served (head dim, group) pairs and their cuts: (128, 8) keeps
        tiles of 8 tokens and three CTAs an SM; (256, 10) takes 4 and 2;
        (128, 2) and (128, 6) are cut as (128, 8), (128, 9) and (128, 16) as
        (256, 10) with 64-key stages.  An unbuilt pair raises; its plans
        (made for the CPU's plain path, which reads none) take the default
        tile."""
        assert flash_attention.SERVED == {(128, 8), (256, 10), (128, 2), (128, 9), (128, 6),
                                          (128, 16)}
        assert flash_attention.instance(128, 6) == (8, 2, 64, 3)
        assert flash_attention.instance(128, 16) == (4, 1, 64, 2)
        assert flash_attention.instance(128, 8) == (8, 2, 64, 3)
        assert flash_attention.instance(256, 10) == (4, 1, 32, 2)
        assert flash_attention.instance(128, 2) == (8, 2, 64, 3)
        assert flash_attention.instance(128, 9) == (4, 1, 64, 2)
        for inst in flash_attention.INSTANCES.values():
            assert inst.tile_tokens == 4 * inst.tokens_per_warp  # four warps a CTA
            assert inst.stage_keys % 16 == 0
            # a split fills a stage
            assert flash_attention.SPLIT_MIN_BLOCKS * 16 >= inst.stage_keys
        with pytest.raises(ValueError, match="built for"):
            flash_attention.instance(64, 2)
        assert flash_attention.tile_tokens(256, 10) == 4
        assert flash_attention.tile_tokens(64, 2) == flash_attention.TILE_TOKENS == 8
        # the instance's CTAs an SM set where a decode grid stops splitting
        assert flash_attention.split_blocks(16, 130, 132, 2) == (17, 8)
        assert flash_attention.split_blocks(16, 130, 132) == (22, 6)

    @pytest.mark.parametrize("packed", [False, True])
    def test_step_rows_bound_the_d256_g10_plans(self, packed):
        """``step_plan_rows`` at 4 tokens a tile bounds every step's tiles,
        as it does at 8 (``test_torch_graphs.py``)."""
        rng = np.random.default_rng(2)
        b, c = 8, 64
        rows = flash_attention.step_plan_rows(b * c if not packed else 257, b, packed, 4)
        for _ in range(20):
            if packed:
                spans = rng.multinomial(int(rng.integers(8, 257)), np.ones(b) / b)
                slots = np.r_[np.repeat(np.arange(b), spans), [-1] * (257 - spans.sum())]
                pos = np.r_[np.concatenate([np.arange(n) + 100 for n in spans]),
                            [0] * (257 - spans.sum())]
            else:
                lens = rng.integers(0, c + 1, b)
                offs = np.arange(c)
                slots = np.where(offs[None] < lens[:, None], np.arange(b)[:, None], -1).ravel()
                pos = (rng.integers(0, 500, b)[:, None] + offs[None]).ravel()
            plan = flash_attention.paged_tile_plan(pos, slots, 16, 40, 0, rows, 4)
            assert len(plan) == rows and plan[:, 1].max() <= 4
        assert flash_attention.step_plan_rows(8 * 64, 8, False, 4) == 8 * 17

    def test_planted_faults_of_the_d256_g10_check_are_caught(self):
        """The card check's two planted faults move the output past
        ``K4_TOL``: queries of heads 8-9 zeroed (a kernel whose second n8
        tile read no Q), and one split's blocks masked for one token (a
        merge that dropped that split's partial)."""
        inst = flash_attention.INSTANCES[256, 10]
        a = packed_scenario(page_size=16, kvh=1, h=10, d=256, seed=5, lens=(300, 40, 190))
        keep = np.r_[0, 4, len(a["q_pos"]) - 1]
        a = dict(a, q=a["q"][keep], q_pos=a["q_pos"][keep], q_slots=a["q_slots"][keep])
        ta = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
        want = ref.paged_attention_ref(**ta)
        q_cut = ta["q"].clone()
        q_cut[:, 8:10] = 0
        no_heads = ref.paged_attention_ref(**dict(ta, q=q_cut))
        splits, per = flash_attention.split_blocks(3, a["tables"].shape[1], 132,
                                                   inst.ctas_per_sm)
        assert splits >= 3
        tables = torch.cat([ta["tables"], ta["tables"][:1]])
        tables[-1, per:2 * per] = -1
        slots = ta["q_slots"].clone()
        slots[0] = tables.shape[0] - 1
        dropped = ref.paged_attention_ref(**dict(ta, tables=tables, q_slots=slots))
        for bad in (no_heads, dropped):
            assert not torch.allclose(bad, want, atol=2e-2, rtol=2e-2)
        assert torch.equal(no_heads[:, :8], want[:, :8])  # only heads 8-9 move
        assert torch.equal(dropped[1:], want[1:])  # only the one token moves

    def test_planted_skip_of_a_tiles_last_page_is_caught(self):
        """``skip_last_page`` (the card checks' planted fault) moves a tile's
        output past ``K4_TOL``."""
        a = plan_scenario("mixed")
        ta = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
        want = ref.paged_attention_ref(**ta)
        plan = flash_attention.paged_tile_plan(a["q_pos"], a["q_slots"], 4, a["tables"].shape[1])
        bad = {k: torch.from_numpy(np.asarray(v)) for k, v in skip_last_page(a, plan[0]).items()}
        got = ref.paged_attention_ref(**bad)
        assert not torch.allclose(got, want, atol=2e-2, rtol=2e-2)
        t0, n = plan[0, :2]
        others = np.ones(len(a["q_pos"]), bool)
        others[t0:t0 + n] = False
        assert torch.equal(got[others], want[others])


#: the forward's main-path shapes (rows, d, itemsize): qwen2.5-3b's decode
#: step, packed mixed step and training micro-batch, Mamba-2's training
#: micro-batch; then ragged counts and f32
FWD_SHAPES = [(8, 2048, 2), (257, 2048, 2), (2048, 2048, 2), (8192, 768, 2),
              (1, 768, 2), (3, 2048, 2), (8191, 768, 2), (257, 2048, 4), (8192, 768, 4),
              (100000, 2048, 4), (600, 29000, 4)]


def walk_fwd(x, s, plan, model=False):
    """A numpy walk of the forward kernel's schedule (``rmsnorm.cu``
    ``rmsnorm_fwd_rows``) with the plan it launches: per CTA, the first
    ``slots`` stages loaded, then stage by stage each row of the stage
    normalised out of its slot (by the plain version) and, once the whole
    stage is read, stage k + slots loaded into the same slot.  Asserts that
    a slot is read only holding its stage and refilled only once read, and
    that every row is written once."""
    rows, d = x.shape
    out = torch.full_like(x, float("nan"))
    written = np.zeros(rows, int)
    fn = ref.rmsnorm_model if model else ref.rmsnorm_ref
    for c in range(plan.ctas):
        r0 = c * plan.rows_per_cta
        nrows = min(rows, r0 + plan.rows_per_cta) - r0
        stages = -(-nrows // plan.stage_rows)
        ring = [None] * plan.slots  # [stage, its rows, read?] a slot holds

        def load(k):
            slot = ring[k % plan.slots]
            assert slot is None or slot[2], "a slot refilled before it was read"
            lo = r0 + k * plan.stage_rows
            ring[k % plan.slots] = [k, x[lo:min(lo + plan.stage_rows, r0 + nrows)].clone(), False]

        for k in range(min(plan.slots, stages)):
            load(k)
        for k in range(stages):
            slot = ring[k % plan.slots]
            assert slot[0] == k and not slot[2], f"CTA {c} stage {k} not in its slot"
            lo = r0 + k * plan.stage_rows
            out[lo:lo + len(slot[1])] = fn(slot[1], s)
            written[lo:lo + len(slot[1])] += 1
            slot[2] = True
            if k + plan.slots < stages:
                load(k + plan.slots)
    assert (written == 1).all()
    return out


class TestRmsnormForwardPartition:
    @pytest.mark.parametrize("rows,d,itemsize", FWD_SHAPES)
    def test_every_row_once_contiguously(self, rows, d, itemsize):
        """``fwd_partition`` at 132 SMs: CTA c takes the contiguous rows
        [c * rows_per_cta, ...), every row in one CTA, no CTA empty, at most
        ``FWD_CTAS_PER_SM`` CTAs an SM; a small count takes a CTA a row."""
        plan = rmsnorm.fwd_partition(rows, d, itemsize, 132)
        assert plan.ctas <= 132 * rmsnorm.FWD_CTAS_PER_SM
        seen = np.zeros(rows, int)
        for c in range(plan.ctas):
            r = np.arange(c * plan.rows_per_cta, min((c + 1) * plan.rows_per_cta, rows))
            assert len(r) > 0
            seen[r] += 1
        assert (seen == 1).all()
        if rows <= 132 * rmsnorm.FWD_CTAS_PER_SM:  # decode, the packed step: a CTA a row
            assert plan[:4] == (rows, 1, 1, 1)
        if (rows, d, itemsize) == (8192, 768, 2):  # Mamba-2's micro-batch: 2 stages in flight
            assert plan[:4] == (512, 16, 8, 2)
        if (rows, d, itemsize) == (2048, 2048, 2):  # qwen's: one stage of 16 KB
            assert plan[:4] == (512, 4, 4, 1)

    @pytest.mark.parametrize("rows,d,itemsize", FWD_SHAPES)
    def test_stages_fit_the_shared_memory_requested(self, rows, d, itemsize):
        """The ring, the scale row and the mbarriers fit in ``smem``, which
        fits on the card, and in an SM's share for ``FWD_CTAS_PER_SM`` CTAs
        wherever a row fits there; a stage is at most a row a warp and the
        ring at most the kernel's ``kMaxSlots`` (read from the source)."""
        plan = rmsnorm.fwd_partition(rows, d, itemsize, 132)
        src = (rmsnorm._build.KERNEL_DIR / rmsnorm.SOURCE).read_text()
        assert f"kMaxSlots = {rmsnorm.FWD_MAX_SLOTS};" in src
        assert f"kFwdThreads = {32 * rmsnorm.FWD_WARPS};" in src
        assert 1 <= plan.slots <= rmsnorm.FWD_MAX_SLOTS
        assert 1 <= plan.stage_rows <= max(rmsnorm.FWD_WARPS, plan.rows_per_cta)
        head = rmsnorm.FWD_HEAD + -(-4 * d // 16) * 16
        assert head + plan.slots * plan.stage_rows * d * itemsize <= plan.smem <= rmsnorm.SMEM
        if head + d * itemsize <= rmsnorm.FWD_CTA_SMEM:
            assert plan.smem <= rmsnorm.FWD_CTA_SMEM
        assert plan.slots * plan.stage_rows <= -(-plan.rows_per_cta // plan.stage_rows) * plan.stage_rows

    def test_too_wide_a_row_is_refused(self):
        rmsnorm.fwd_partition(4, 29000, 4, 132)  # 116,000 B beside its f32 scale row: fits
        for d, itemsize in ((29100, 4), (1 << 16, 2)):
            with pytest.raises(ValueError, match="shared memory"):
                rmsnorm.fwd_partition(4, d, itemsize, 132)
        with pytest.raises(ValueError, match="positive"):
            rmsnorm.fwd_partition(0, 768, 2, 132)

    @pytest.mark.parametrize("rows,d,sms,model", [
        (257, 64, 132, True),  # small count: 257 CTAs of one row
        (1000, 512, 16, False),  # 2 stages a CTA, both in flight
        (5000, 512, 4, True),  # a ring of 3 slots refilled (40 stages a CTA)
        (50, 20000, 4, False),  # one slot: each stage loaded once the last one is read
    ])
    def test_walk_of_the_stage_ring_matches_the_plain_version(self, rows, d, sms, model):
        rng = np.random.default_rng(rows)
        x = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32))
        s = torch.from_numpy((1 + 0.1 * rng.normal(size=d)).astype(np.float32))
        plan = rmsnorm.fwd_partition(rows, d, 4, sms)
        got = walk_fwd(x, s, plan, model)
        assert torch.equal(got, (ref.rmsnorm_model if model else ref.rmsnorm_ref)(x, s))

    def test_planted_fault_fails_the_bf16_ulp_check(self):
        """Each row's last 16-byte vector left out of its sum of squares
        (``rmsnorm_without_last_vector``, the card checks' planted fault) at
        Mamba-2's micro-batch: beyond the one bf16 ulp the card holds the
        kernel to."""
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=(8192, 768)).astype(np.float32)).to(torch.bfloat16)
        s = torch.from_numpy((1 + 0.1 * rng.normal(size=768)).astype(np.float32))
        bad = rmsnorm_without_last_vector(x, s, model=False)
        assert bf16_ulps(bad, ref.rmsnorm_ref(x, s)) > BF16_ULPS
        bad = rmsnorm_without_last_vector(x, s, model=True)
        assert rmsnorm_model_ulps(bad, x, s)[0] > BF16_ULPS

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
    def test_model_ulps_admits_the_other_rounding_of_a_tie_only(self, dtype):
        """``rmsnorm_model_ulps`` (the card's check in model mode): rows
        whose inv is a tie may have it rounded the other way; in any other
        row, a 2-ulp error is still caught."""
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.normal(size=(4000, 256)).astype(np.float32)).to(dtype)
        s = torch.from_numpy((1 + 0.1 * rng.normal(size=256)).astype(np.float32))
        want = ref.rmsnorm_model(x, s)
        ulps, ties = rmsnorm_model_ulps(want, x, s)
        assert ulps == 0 and ties > 0
        inv = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + 1e-6).to(dtype)
        inv64 = torch.rsqrt(x.double().square().mean(-1, keepdim=True) + 1e-6)
        bits = inv.view(torch.int16)
        other = torch.where(inv.double() <= inv64, (bits + 1).view(dtype), (bits - 1).view(dtype))
        flipped = x * other * s.to(dtype)  # every row's inv rounded the other way
        mid = (inv.double() + other.double()) / 2
        tie = ((inv64 - mid).abs() <= K2_INV_TIE * inv64)[:, 0]
        assert rmsnorm_model_ulps(torch.where(tie[:, None], flipped, want), x, s)[0] == 0
        assert rmsnorm_model_ulps(flipped, x, s)[0] > BF16_ULPS  # the rest are no ties
        off = want.clone()
        r = int(torch.nonzero(~tie)[0])
        off[r, 0] = (off[r, 0:1].view(torch.int16) + 2).view(dtype)[0]
        assert rmsnorm_model_ulps(off, x, s)[0] == 2


class TestRmsnormBackwardPartition:
    @pytest.mark.parametrize("rows,d,itemsize", [
        (2048, 2048, 2),  # the training shape: 128 CTAs of 16 rows, one batch each
        (8, 2048, 2), (257, 2048, 4), (3, 100, 2), (100000, 2048, 4), (131, 4096, 4),
        (1, 8, 2)])
    def test_every_row_and_column_once(self, rows, d, itemsize):
        ctas, per, batch, col_ctas = rmsnorm.bwd_partition(rows, d, itemsize, 132)
        assert ctas <= 132
        seen = np.zeros(rows, int)
        for c in range(ctas):
            r = np.arange(c * per, min((c + 1) * per, rows))
            assert len(r) > 0  # no empty CTA
            seen[r] += 1
        assert (seen == 1).all()
        cols = np.zeros(d, int)
        for c in range(col_ctas):
            cols[c * rmsnorm.BWD_COL_CTA:(c + 1) * rmsnorm.BWD_COL_CTA] += 1
        assert (cols == 1).all()
        assert 1 <= batch <= per
        head = (2 * d + batch) * 4
        assert head + (-head) % 16 + 2 * batch * d * itemsize <= rmsnorm.SMEM
        if (rows, d) == (2048, 2048):
            assert (ctas, per, batch, col_ctas) == (128, 16, 16, 64)

    def test_too_wide_a_row_is_refused(self):
        with pytest.raises(ValueError, match="shared memory"):
            rmsnorm.bwd_partition(4, 1 << 16, 4, 132)

    def test_planted_dscale_fault_fails_the_f32_check(self):
        """One CTA's rows left out of dscale (``dscale_without_rows``, the
        card checks' planted fault) at the training row count: far outside
        the f32 tolerance the card holds dscale to (1e-5)."""
        rng = np.random.default_rng(0)
        x, dy = (torch.from_numpy(rng.normal(size=(2048, 256)).astype(np.float32))
                 for _ in range(2))
        s = torch.from_numpy((1 + 0.1 * rng.normal(size=256)).astype(np.float32))
        _, per, _, _ = rmsnorm.bwd_partition(2048, 256, 4, 132)
        want = ref.rmsnorm_bwd_ref(x, s, dy)[1]
        bad = dscale_without_rows(x, s, dy, slice(0, per))
        e = float((bad - want).abs().max() / want.abs().max())
        assert e > 100 * 1e-5


def test_tolerance_table_is_shared():
    """One table for every port test file (later slices extend it)."""
    assert {"kernel_f32", "norm_f32", "model_f32", "kernel_bf16_gpu"} <= set(TOL)


def _c_argtypes(source, entry):
    """ctypes types of a C entry point's parameters, read from the source."""
    import ctypes
    import re

    src = (flash_attention._build.KERNEL_DIR / source).read_text()
    sig = re.search(r'extern "C" int ' + entry + r'\((.*?)\)\s*\{', src, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    kinds = ["p" if "*" in p else ("f" if p.startswith("float") else "i") for p in params]
    want = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    return [want[k] for k in kinds]


def test_ctypes_signature_matches_the_cuda_source():
    """The wrapper's argtypes must list exactly the C entry point's
    parameters, pointer for pointer (a miscount only shows on the card)."""
    assert _c_argtypes(flash_attention.SOURCE, "repro_paged_attention") == \
        flash_attention._ARGTYPES


def test_rmsnorm_bwd_ctypes_signature_matches_the_cuda_source():
    assert _c_argtypes(rmsnorm.SOURCE, "repro_rmsnorm_bwd") == rmsnorm._BWD_ARGTYPES


def test_rmsnorm_fwd_ctypes_signature_matches_the_cuda_source():
    assert _c_argtypes(rmsnorm.SOURCE, "repro_rmsnorm_fwd") == rmsnorm._FWD_ARGTYPES


@pytest.mark.parametrize("entry", ["repro_ssd", "repro_ssd_occupancy", "repro_ssd_bwd",
                                   "repro_ssd_bwd_occupancy"])
def test_ssd_ctypes_signature_matches_the_cuda_source(entry, monkeypatch):
    class Fn:
        pass

    class Lib:
        repro_ssd = Fn()
        repro_ssd_occupancy = Fn()
        repro_ssd_bwd = Fn()
        repro_ssd_bwd_occupancy = Fn()

    monkeypatch.setattr(ssd_chunk._build, "load", lambda source: Lib)
    lib = ssd_chunk.load_library()
    assert _c_argtypes(ssd_chunk.SOURCE, entry) == getattr(lib, entry).argtypes


@pytest.mark.parametrize("entry", ["repro_flash_attention_fwd", "repro_flash_attention_bwd"])
def test_training_ctypes_signatures_match_the_cuda_source(entry, monkeypatch):
    """Same for the training kernels: ``load_train_library`` sets these."""

    class Fn:
        pass

    class Lib:
        repro_flash_attention_fwd = Fn()
        repro_flash_attention_bwd = Fn()

    monkeypatch.setattr(flash_attention._build, "load", lambda source: Lib)
    lib = flash_attention.load_train_library()
    assert _c_argtypes(flash_attention.TRAIN_SOURCE, entry) == getattr(lib, entry).argtypes


# ---------------------------------------------------------------------------
# K3: training flash attention (plain forward / backward)
# ---------------------------------------------------------------------------


@pytest.fixture
def pallas_load(monkeypatch):
    """The reference's flash-attention kernel calls ``pl.load``
    (``src/repro/kernels/flash_attention.py:61-62``, ``:72``), which jax 0.9
    removed; its interpret-mode run gets it back as the plain ref indexing
    it became, in this test process only (the JAX package is unchanged)."""
    if not hasattr(pl, "load"):
        monkeypatch.setattr(pl, "load", lambda r, idx: r[idx], raising=False)


def _qkv(b, h, kvh, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, kvh, sk, d)).astype(np.float32),
            rng.normal(size=(b, kvh, sk, d)).astype(np.float32))


def _both_fwd(arrs, dtype="float32", **kw):
    """(interpret-mode Pallas kernel at its 128/128 blocks, the port's plain
    forward) on the same inputs."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    want = jops.flash_attention(*(jnp.asarray(a, dtype) for a in arrs), interpret=True, **jkw)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    got, lse = ref.flash_attention_fwd_ref(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs), **tkw)
    return want, got, lse


class TestFlashAttentionPlain:
    @pytest.mark.parametrize("b,h,kv,s,d", [
        (1, 4, 4, 128, 64),   # MHA
        (2, 4, 2, 256, 64),   # GQA
        (1, 8, 1, 256, 32),   # MQA
        (2, 2, 2, 384, 128),  # non-pow2 seq multiple of block
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_causal_matches_interpret_kernel(self, pallas_load, b, h, kv, s, d, dtype):
        want, got, _ = _both_fwd(_qkv(b, h, kv, s, s, d, seed=s + h), dtype, causal=True)
        if dtype == "float32":
            assert_close(got, want, "kernel_f32")
        else:  # the JAX suite's own bf16 tolerance (test_kernels.py:33)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       atol=2e-2)

    @pytest.mark.parametrize("window", [64, 128])
    def test_sliding_window(self, pallas_load, window):
        want, got, _ = _both_fwd(_qkv(1, 4, 2, 256, 256, 64, seed=3), causal=True, window=window)
        assert_close(got, want, "kernel_f32")

    @pytest.mark.parametrize("sq,sk,causal", [(128, 128, False), (128, 256, True)])
    def test_non_causal_and_right_aligned(self, pallas_load, sq, sk, causal):
        want, got, _ = _both_fwd(_qkv(1, 2, 2, sq, sk, 64, seed=6), causal=causal)
        assert_close(got, want, "kernel_f32")

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_bert_heads_non_causal(self, pallas_load, dtype):
        """The (head dim 64, group 1) bidirectional build's case: bert-1.5b's
        25 heads, one KV head each, at its 128 tokens."""
        want, got, _ = _both_fwd(_qkv(2, 25, 25, 128, 128, 64, seed=25), dtype, causal=False)
        if dtype == "float32":
            assert_close(got, want, "kernel_f32")
        else:  # the JAX suite's own bf16 tolerance (test_kernels.py:33)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       atol=2e-2)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_recurrentgemma_heads_windowed(self, pallas_load, dtype):
        """The (head dim 256, group 10) build's case: recurrentgemma-2b's 10
        heads on one KV head, causal under a window whose edge falls inside
        the kernel's 128-key blocks."""
        want, got, _ = _both_fwd(_qkv(1, 10, 1, 256, 256, 256, seed=10), dtype, causal=True,
                                 window=100)
        if dtype == "float32":
            assert_close(got, want, "kernel_f32")
        else:  # the JAX suite's own bf16 tolerance (test_kernels.py:33)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       atol=2e-2)

    @pytest.mark.parametrize("window", [0, 64])
    def test_segment_ids(self, pallas_load, window):
        seg = np.zeros((2, 256), np.int32)
        seg[:, 96:] += 1
        seg[:, 160:] += 1
        want, got, _ = _both_fwd(_qkv(2, 4, 2, 256, 256, 64, seed=9), causal=True,
                                 window=window, q_segment_ids=seg, kv_segment_ids=seg)
        assert_close(got, want, "kernel_f32")

    def test_query_without_keys_keeps_the_kernels_quirk(self, pallas_load):
        """A query whose segment no key shares: the TPU kernel at its
        default 128/128 blocks returns the mean of the values it visited
        (``flash_attention.py:110-112``); the plain version returns the
        same, not zeros and not the oracle's uniform mix of every key."""
        s = 256
        seg = np.zeros((1, s), np.int32)
        seg[:, 128:] = 1
        qseg = seg.copy()
        qseg[:, 40:50] = 5  # rows in the first 128-row block: keys [0, 128)
        qseg[:, 200:210] = 6  # rows in the second: keys [0, 256)
        arrs = _qkv(1, 4, 2, s, s, 64, seed=12)
        want, got, _ = _both_fwd(arrs, causal=True, q_segment_ids=qseg, kv_segment_ids=seg)
        assert_close(got, want, "kernel_f32")
        v = arrs[2]
        np.testing.assert_allclose(got[0, 0, 45].numpy(), v[0, 0, :128].mean(0), atol=1e-5)
        np.testing.assert_allclose(got[0, 0, 205].numpy(), v[0, 0, :256].mean(0), atol=1e-5)
        oracle = jref.flash_attention_ref(*(jnp.asarray(a) for a in arrs), causal=True,
                                          q_segment_ids=jnp.asarray(qseg),
                                          kv_segment_ids=jnp.asarray(seg))
        assert np.abs(np.asarray(oracle)[0, 0, 45] - got[0, 0, 45].numpy()).max() > 1e-3

    def test_visited_keys_match_the_kernels_bounds(self):
        """``visited_keys`` is ``_attn_kernel``'s lo/hi (:45-53) at 128/128."""
        lo, hi = ref.visited_keys(256, 256, causal=True, window=0)
        assert lo.tolist() == [0] * 256
        assert hi.tolist() == [128] * 128 + [256] * 128
        lo, hi = ref.visited_keys(384, 384, causal=True, window=100)
        assert lo.tolist() == [0] * 256 + [128] * 128
        lo, hi = ref.visited_keys(128, 256, causal=True, window=0)  # right-aligned
        assert hi.tolist() == [256] * 128

    def test_half_passed_segment_ids_raise(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 8, 8, 4, seed=1))
        with pytest.raises(ValueError, match="segment"):
            ref.flash_attention_fwd_ref(q, k, v, q_segment_ids=torch.zeros(1, 8))


def _jax_grads(fn, q, k, v, do):
    """jax.grad of sum(fn(q, k, v) * do) in the model's (B, S, heads, D) layout."""
    return jax.grad(lambda q_, k_, v_: jnp.sum(fn(q_, k_, v_) * do), argnums=(0, 1, 2))(q, k, v)


class TestFlashAttentionBackwardPlain:
    @pytest.mark.parametrize("h,kvh,s,window", [(4, 2, 48, 0), (4, 1, 40, 0), (4, 2, 48, 16),
                                                (2, 2, 33, 0)])
    def test_matches_grad_of_sdpa(self, h, kvh, s, window):
        """The explicit backward against ``jax.grad`` of ``layers.sdpa`` (the
        reference's path up to 2048 tokens), f32."""
        rng = np.random.default_rng(s + h + window)
        q = rng.normal(size=(2, s, h, 16)).astype(np.float32)
        k, v = (rng.normal(size=(2, s, kvh, 16)).astype(np.float32) for _ in range(2))
        do = rng.normal(size=q.shape).astype(np.float32)
        mask = jlayers.causal_mask(s, s, window=window)
        want = _jax_grads(lambda a, b, c: jlayers.sdpa(a, b, c, mask), *map(jnp.asarray,
                                                                             (q, k, v, do)))
        tq, tk, tv, tdo = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, do))
        out, lse = ref.flash_attention_fwd_ref(tq, tk, tv, causal=True, window=window)
        got = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal=True, window=window)
        for g, w in zip(got, want):
            assert_close(g.transpose(1, 2), w, "kernel_f32")

    def test_matches_grad_of_banded_sdpa_at_recurrentgemma_heads(self):
        """At (head dim 256, group 10) and 64 tokens under a 16-token window,
        the reference's 'L' layer takes ``layers.sdpa_local_banded`` (sq >
        2 x window): the explicit backward against its ``jax.grad``, f32."""
        rng = np.random.default_rng(10)
        q = rng.normal(size=(1, 64, 10, 256)).astype(np.float32)
        k, v = (rng.normal(size=(1, 64, 1, 256)).astype(np.float32) for _ in range(2))
        do = rng.normal(size=q.shape).astype(np.float32)
        want = _jax_grads(lambda a, b, c: jlayers.sdpa_local_banded(a, b, c, 16),
                          *map(jnp.asarray, (q, k, v, do)))
        tq, tk, tv, tdo = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, do))
        out, lse = ref.flash_attention_fwd_ref(tq, tk, tv, causal=True, window=16)
        got = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal=True, window=16)
        for g, w in zip(got, want):
            assert_close(g.transpose(1, 2), w, "kernel_f32")

    def test_non_causal_matches_grad_of_mask_free_sdpa(self):
        """The bidirectional backward ('B' layers) against ``jax.grad`` of the
        reference's ``sdpa(q, k, v, None)``, one KV head a query head, f32."""
        rng = np.random.default_rng(25)
        q, k, v, do = (rng.normal(size=(2, 40, 5, 16)).astype(np.float32) for _ in range(4))
        want = _jax_grads(lambda a, b, c: jlayers.sdpa(a, b, c, None),
                          *map(jnp.asarray, (q, k, v, do)))
        tq, tk, tv, tdo = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, do))
        out, lse = ref.flash_attention_fwd_ref(tq, tk, tv, causal=False)
        got = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal=False)
        for g, w in zip(got, want):
            assert_close(g.transpose(1, 2), w, "kernel_f32")

    def test_matches_grad_of_sdpa_flash(self):
        """... and of ``layers.sdpa_flash`` (above 2048 tokens), at small
        chunks so several query and key chunks meet."""
        rng = np.random.default_rng(4)
        q = rng.normal(size=(1, 64, 4, 16)).astype(np.float32)
        k, v = (rng.normal(size=(1, 64, 2, 16)).astype(np.float32) for _ in range(2))
        do = rng.normal(size=q.shape).astype(np.float32)
        want = _jax_grads(lambda a, b, c: jlayers.sdpa_flash(a, b, c, causal=True, q_chunk=16,
                                                             k_chunk=32),
                          *map(jnp.asarray, (q, k, v, do)))
        tq, tk, tv = (torch.from_numpy(a).transpose(1, 2).requires_grad_() for a in (q, k, v))
        ops.flash_attention(tq, tk, tv, causal=True).backward(
            torch.from_numpy(do).transpose(1, 2))
        for g, w in zip((tq.grad, tk.grad, tv.grad), want):
            assert_close(g.transpose(1, 2), w, "kernel_f32")

    def test_autograd_function_equals_plain_formula(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 24, 24, 8, seed=5))
        do = torch.randn(1, 4, 24, 8)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        ops.flash_attention(*leaves, window=5).backward(do)
        out, lse = ref.flash_attention_fwd_ref(q, k, v, window=5)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, window=5)
        for leaf, w in zip(leaves, want):
            assert torch.equal(leaf.grad, w)


    @pytest.mark.parametrize("window,segments", [(0, False), (5, False), (0, True)])
    def test_explicit_mask_equals_the_built_one(self, window, segments):
        q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 2, 24, 24, 8, seed=9))
        do = torch.randn(2, 4, 24, 8, generator=torch.Generator().manual_seed(9))
        kw = dict(causal=True, window=window)
        if segments:
            seg = torch.tensor([[0] * 10 + [1] * 14, [0] * 20 + [1] * 4])
            kw.update(q_segment_ids=seg, kv_segment_ids=seg)
        mask = ref.attention_mask(24, 24, True, window, kw.get("q_segment_ids"),
                                  kw.get("kv_segment_ids"))
        out, lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
        got, got_lse = ref.flash_attention_fwd_ref(q, k, v, mask=mask)
        assert torch.equal(got, out) and torch.equal(got_lse, lse)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
        for g, w in zip(ref.flash_attention_bwd_ref(q, k, v, out, lse, do, mask=mask), want):
            assert torch.equal(g, w)


def test_k3_row_metric_separates_rounding_from_a_planted_fault():
    """The card checks' K3 metric (``row_rel_err`` under ``K3_ROW_TOL``)
    passes the plain version's own bf16 rounding of out, dq, dk and dv, and
    fails each of them under the planted fault (the diagonal 64-key tile
    skipped for the later half of the rows), at qwen2.5-3b's head layout."""
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, s, h, 128)).astype(np.float32))
                   .to(torch.bfloat16).float().transpose(1, 2)
                   for s, h in ((512, 16), (512, 2), (512, 2), (512, 16)))
    want, lse = ref.flash_attention_fwd_ref(q, k, v)
    wants = ref.flash_attention_bwd_ref(q, k, v, want, lse, do)
    mask = skip_diagonal_tile_mask(512)
    bad, bad_lse = ref.flash_attention_fwd_ref(q, k, v, mask=mask)
    bads = ref.flash_attention_bwd_ref(q, k, v, bad, bad_lse, do, mask=mask)
    for fault, w in zip((bad, *bads), (want, *wants)):
        rounded = w.to(torch.bfloat16)
        assert row_rel_err(rounded, w) <= K3_ROW_TOL < row_rel_err(fault.to(torch.bfloat16), w)


# ---------------------------------------------------------------------------
# K3: the tile plan the CUDA kernels read as their schedule
# ---------------------------------------------------------------------------


def _tpu_visited(sq, sk, causal, window):
    """Per query row, the keys ``[lo, hi)`` that the TPU kernel walks at its
    default 128/128 blocks: ``_attn_kernel``'s bounds
    (``src/repro/kernels/flash_attention.py:45-53``) written out again for
    the 128-row block holding each row."""
    bq, bk = min(128, sq), min(128, sk)
    lo, hi = np.zeros(sq, np.int64), np.zeros(sq, np.int64)
    for i in range(sq):
        q_start = i // bq * bq
        h = min((q_start + bq - 1 + (sk - sq)) // bk + 1, sk // bk) if causal else sk // bk
        l_ = max((q_start + (sk - sq) - window + 1) // bk, 0) if window > 0 else 0
        lo[i], hi[i] = l_ * bk, h * bk
    return lo, hi


_PLAN_SHAPES = [(64, 64), (128, 128), (256, 256), (2048, 2048),  # square
                (64, 128), (128, 256), (256, 2048), (64, 2048)]  # right-aligned


class TestTilePlan:
    """``flash_attention.tile_plan`` against ``ref.attention_mask`` and the
    TPU kernel's visited range: every admissible pair lies in a tile some
    CTA visits, a tile marked mask-free holds only admissible pairs, every
    outer tile has one CTA, and CTAs run longest walk first."""

    @staticmethod
    def _covered(kind, sq, sk, causal, window):
        plan = flash_attention.tile_plan(kind, sq, sk, causal, window)
        outer_n, inner = flash_attention.PLAN_KINDS[kind]
        mask = ref.attention_mask(sq, sk, causal, window)[0].numpy()
        if kind == "dkdv":
            mask = mask.T  # (keys, queries): outer first
        n_outer, n_inner = mask.shape
        visited = np.zeros_like(mask)
        free = np.zeros_like(mask)
        for start, lo, hi, f_lo, f_hi, end in plan.tolist():
            rows = slice(start, min(start + outer_n, n_outer))
            visited[rows, lo * inner:min(hi * inner, end)] = True
            assert lo <= f_lo <= f_hi <= hi
            if f_hi > f_lo:
                assert f_hi * inner <= end <= n_inner
                free[rows, f_lo * inner:f_hi * inner] = True
        return plan, mask, visited, free

    @pytest.mark.parametrize("kind", ["fwd", "dkdv", "dq"])
    @pytest.mark.parametrize("window", [0, 1, 100, 256])
    @pytest.mark.parametrize("sq,sk", _PLAN_SHAPES)
    def test_covers_every_admissible_pair(self, kind, sq, sk, window):
        plan, mask, visited, free = self._covered(kind, sq, sk, True, window)
        assert not (mask & ~visited).any()  # every admissible pair is visited
        assert not (free & ~mask).any()  # mask-free tiles hold only admissible pairs
        outer_n = flash_attention.PLAN_KINDS[kind][0]
        assert sorted(plan[:, 0].tolist()) == list(range(0, mask.shape[0], outer_n))
        walk = plan[:, 2] - plan[:, 1]
        assert (np.diff(walk) <= 0).all()  # longest walk first
        if kind != "fwd":  # the backward visits only tiles holding an admissible pair
            inner = flash_attention.PLAN_KINDS[kind][1]
            for start, lo, hi, *_ in plan.tolist():
                rows = mask[start:start + outer_n]
                for t in range(lo, hi):
                    assert rows[:, t * inner:(t + 1) * inner].any()

    @pytest.mark.parametrize("kind", ["fwd", "dkdv", "dq"])
    @pytest.mark.parametrize("window", [0, 100])
    @pytest.mark.parametrize("s", [64, 128, 2048])
    def test_non_causal(self, kind, s, window):
        plan, mask, visited, free = self._covered(kind, s, s, False, window)
        assert not (mask & ~visited).any()
        assert not (free & ~mask).any()

    @pytest.mark.parametrize("window", [0, 1, 100, 256])
    @pytest.mark.parametrize("sq,sk", _PLAN_SHAPES)
    def test_forward_visits_the_tpu_kernels_range(self, sq, sk, window):
        """The forward's key range per query row is ``_attn_kernel``'s
        lo/hi, the range whose mean a query without keys returns."""
        plan = flash_attention.tile_plan("fwd", sq, sk, True, window)
        lo, hi = np.zeros(sq, np.int64), np.zeros(sq, np.int64)
        outer_n, inner = flash_attention.PLAN_KINDS["fwd"]
        for start, t_lo, t_hi, _, _, end in plan.tolist():
            rows = slice(start, start + outer_n)
            lo[rows], hi[rows] = t_lo * inner, min(t_hi * inner, end)
        want_lo, want_hi = _tpu_visited(sq, sk, True, window)
        np.testing.assert_array_equal(lo, want_lo)
        np.testing.assert_array_equal(hi, want_hi)
        ref_lo, ref_hi = ref.visited_keys(sq, sk, True, window)
        np.testing.assert_array_equal(lo, ref_lo.numpy())
        np.testing.assert_array_equal(hi, ref_hi.numpy())

    def test_causal_training_shape(self):
        """At S 2048: 16 query tiles, the last one (32 key steps) first, its
        two diagonal steps alone masked."""
        plan = flash_attention.tile_plan("fwd", 2048, 2048, True, 0)
        assert plan[0].tolist() == [1920, 0, 32, 0, 30, 2048]
        assert plan[-1].tolist() == [0, 0, 2, 0, 0, 128]
        dkdv = flash_attention.tile_plan("dkdv", 2048, 2048, True, 0)
        assert dkdv[0].tolist() == [0, 0, 32, 1, 32, 2048]  # key tile 0: every query step

    def test_windowed_training_shape(self):
        """recurrentgemma-2b's training attention (S 8,192, causal, window
        2,048), the key-step ranges the card's checks plant faults in: every
        admissible pair covered and every mask-free tile admissible; a
        forward or dQ CTA past the first 2,048 rows walks (2,048 + 128) / 64
        = 34 key steps, 4 of them masked (the window's lower edge, the
        diagonal), a dK/dV CTA at most 33 query steps, 2 masked; the window
        leaves 1,904 of the causal schedule's 4,160 forward steps."""
        s, w = 8192, 2048
        for kind, most, masked in (("fwd", 34, 4), ("dkdv", 33, 2), ("dq", 34, 4)):
            plan, mask, visited, free = self._covered(kind, s, s, True, w)
            assert not (mask & ~visited).any() and not (free & ~mask).any()
            walk = plan[:, 2] - plan[:, 1]
            assert walk.max() == most
            assert (walk - (plan[:, 4] - plan[:, 3])).max() == masked
        fwd = flash_attention.tile_plan("fwd", s, s, True, w)
        assert fwd[0].tolist() == [2048, 0, 34, 2, 32, 2176]  # first of the full walks
        last = fwd[fwd[:, 0] == s - 128][0].tolist()
        assert last == [s - 128, 94, 128, 96, 126, s]  # keys 6,016-8,191: lo edge 6,017
        assert int((fwd[:, 2] - fwd[:, 1]).sum()) == 1904
        causal = flash_attention.tile_plan("fwd", s, s, True, 0)
        assert int((causal[:, 2] - causal[:, 1]).sum()) == 4160
        assert (flash_attention.tile_plan("dq", s, s, True, w)[:, 1:5] == fwd[:, 1:5]).all()

    def test_device_plan_is_made_once(self):
        a = flash_attention._plan_tensor("dq", 256, 256, True, 0, torch.device("cpu"))
        b = flash_attention._plan_tensor("dq", 256, 256, True, 0, torch.device("cpu"))
        assert a is b and a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), flash_attention.tile_plan("dq", 256, 256, True, 0))


# ---------------------------------------------------------------------------
# K2 backward and K1
# ---------------------------------------------------------------------------


class TestRmsnormBackwardPlain:
    @pytest.mark.parametrize("shape", [(4, 128), (2, 9, 256), (513, 64)])
    def test_model_mode_matches_grad_of_apply_norm(self, shape):
        rng = np.random.default_rng(sum(shape))
        x = (3 * rng.normal(size=shape)).astype(np.float32)
        s = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
        dy = rng.normal(size=shape).astype(np.float32)
        cfg = JConfig(d_model=shape[-1], dtype="float32")
        want_x, want_s = jax.grad(
            lambda x_, s_: jnp.sum(jlayers.apply_norm({"scale": s_}, x_, cfg) * dy),
            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
        dx, ds = ref.rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(s),
                                     torch.from_numpy(dy), model=True)
        assert_close(dx, want_x, "kernel_f32")
        assert_close(ds, want_s, "model_f32")  # a sum over up to 513 rows

    def test_kernel_mode_matches_grad_of_rmsnorm_ref(self):
        rng = np.random.default_rng(1)
        x, dy = (rng.normal(size=(17, 256)).astype(np.float32) for _ in range(2))
        s = (1 + 0.1 * rng.normal(size=256)).astype(np.float32)
        want_x, want_s = jax.grad(lambda x_, s_: jnp.sum(jref.rmsnorm_ref(x_, s_) * dy),
                                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
        dx, ds = ref.rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(s),
                                     torch.from_numpy(dy), model=False)
        assert_close(dx, want_x, "kernel_f32")
        assert_close(ds, want_s, "kernel_f32")

    def test_autograd_function_equals_plain_formula(self):
        x = torch.randn(6, 64, requires_grad=True)
        s = (1 + 0.1 * torch.randn(64)).requires_grad_()
        dy = torch.randn(6, 64)
        ops.rmsnorm(x, s, model=True).backward(dy)
        dx, ds = ref.rmsnorm_bwd_ref(x.detach(), s.detach(), dy, model=True)
        assert torch.equal(x.grad, dx) and torch.equal(s.grad, ds)


class TestMaskedAccumPlain:
    @pytest.mark.parametrize("n", [128, 1000, 65536 + 3])
    @pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
    def test_matches_interpret_kernel(self, n, gdtype):
        rng = np.random.default_rng(n)
        acc = rng.normal(size=n).astype(np.float32)
        g = rng.normal(size=n).astype(np.float32)
        for keep in (0.0, 1.0):
            want = jops.masked_accum(jnp.asarray(acc), jnp.asarray(g, gdtype), jnp.float32(keep),
                                     scale=0.125, interpret=True)
            got = ops.masked_accum(torch.from_numpy(acc.copy()),
                                   torch.from_numpy(g).to(getattr(torch, gdtype)), keep, 0.125)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_keep_zero_leaves_the_accumulator_untouched(self):
        acc = torch.randn(257)
        before = acc.clone()
        ops.masked_accum(acc, torch.randn(257), 0.0)
        assert torch.equal(acc, before)


# ---------------------------------------------------------------------------
# K6 / K5: the SSD intra-chunk and segment-masked terms (plain versions)
# ---------------------------------------------------------------------------


class TestSsdPlain:
    @pytest.mark.parametrize("bs,nc,l,h,p,n", [
        (1, 2, 64, 2, 32, 16),
        (2, 1, 128, 3, 64, 32),
        (1, 4, 32, 1, 16, 8),
        (2, 1, 20, 3, 8, 4),  # a chunk length off any tile
    ])
    def test_chunk_matches_interpret_kernel_and_ref(self, bs, nc, l, h, p, n):
        a = ssd_chunk_inputs(bs, nc, l, h, p, n, seed=l + h)
        kern = jops.ssd_chunk(*map(jnp.asarray, a), interpret=True)
        oracle = jref.ssd_chunk_ref(*map(jnp.asarray, a))
        got = ops.ssd_chunk(*(torch.from_numpy(v) for v in a))
        assert got.dtype == torch.float32 and tuple(got.shape) == (bs, nc, l, h, p)
        assert_close(got, kern, "ssd_f32")
        assert_close(got, oracle, "ssd_f32")

    def test_chunk_mask_override(self):
        """``mask`` replaces the causal triangle (how a check plants a
        kernel fault): the triangle itself changes nothing, the triangle
        less its diagonal 16-key tiles changes every row."""
        a = [torch.from_numpy(v) for v in ssd_chunk_inputs(1, 1, 32, 2, 8, 4, seed=3)]
        tri = torch.ones(32, 32, dtype=torch.bool).tril()
        assert torch.equal(ref.ssd_chunk_ref(*a, mask=tri), ref.ssd_chunk_ref(*a))
        bad = ref.ssd_chunk_ref(*a, mask=ssd_skip_diagonal_tile_mask(32, tile=16))
        assert (bad - ref.ssd_chunk_ref(*a)).abs().amax(dim=(0, 1, 3, 4)).min() > 1e-3

    @pytest.mark.parametrize("seg", [
        [0] * 5 + [1] * 7 + [2] * 3 + [-1] * 3,
        [3] * 9 + [0] * 1 + [2] * 12 + [-1] * 1,  # slots out of order, one single-token segment
        [-1] * 4,  # nothing but padding
    ])
    def test_segment_matches_interpret_kernel_and_ref(self, seg):
        a = ssd_segment_inputs(seg, h=3, p=8, n=4, seed=len(seg))
        kern = jops.ssd_segment(*map(jnp.asarray, a), interpret=True)
        oracle = jref.ssd_segment_ref(*map(jnp.asarray, a))
        got = ops.ssd_segment(*(torch.from_numpy(v) for v in a))
        assert_close(got, kern, "ssd_f32")
        assert_close(got, oracle, "ssd_f32")
        pad = np.asarray(seg) < 0
        assert (got[torch.from_numpy(pad)] == 0).all()  # padding rows: exact zeros

    def test_segment_isolates_requests(self):
        """A token's term is its own segment's alone: changing another
        segment's inputs leaves it bit for bit."""
        seg = [0] * 6 + [1] * 6
        a = [torch.from_numpy(v) for v in ssd_segment_inputs(seg, h=2, p=4, n=3, seed=1)]
        before = ops.ssd_segment(*a)
        a[0][:6] += 5.0
        a[3][:6] -= 1.0
        after = ops.ssd_segment(*a)
        assert torch.equal(before[6:], after[6:])
        assert not torch.equal(before[:6], after[:6])

    def test_segment_large_cumulative_decay(self):
        """Over a 257-token packed axis with a up to 16 the running sum
        reaches the thousands; the decay is formed from differences, so
        the term stays finite and matches the reference."""
        seg = [0] * 100 + [1] * 120 + [2] * 30 + [-1] * 7
        a = ssd_segment_inputs(seg, h=2, p=4, n=3, seed=2, a_max=16.0)
        assert a[2].max() > 1000
        oracle = jref.ssd_segment_ref(*map(jnp.asarray, a))
        got = ops.ssd_segment(*(torch.from_numpy(v) for v in a))
        assert bool(torch.isfinite(got).all())
        assert_close(got, oracle, "ssd_f32")


def segment_start(seg, row0, length):
    """``ssd_chunk.cu``'s ``segment_start``: the first key the 16-row tile
    from ``row0`` admits under K5's mask, the start of its first
    non-padding row's segment (segments are contiguous runs), or -1 when
    every row is padding."""
    rows = [r for r in range(row0, min(row0 + ssd_chunk.ROW_TILE, length)) if seg[r] >= 0]
    if not rows:
        return -1
    r = rows[0]
    while r > 0 and seg[r - 1] == seg[r]:
        r -= 1
    return r


def walk_ssd(x, dt, cum, b, c, seg=None, sms=132, late_start=0, skip_diagonal=False):
    """A numpy walk of the SSD kernels' schedule, f64: each CTA of
    ``ssd_plan`` (its ``work`` map) takes one 16-row tile and its heads;
    it multiplies the 16-key tiles from 0 (K6) or the tile's
    ``segment_start`` (K5) to its diagonal, pair by pair under the mask;
    its 4 warps each write one head's slice of the head dim for the rows
    below L.  Returns y and how many times each element was written.
    ``late_start`` / ``skip_diagonal`` plant faults (the first or the
    diagonal key tile left out)."""
    rt_n = ssd_chunk.ROW_TILE
    gs, length, h, p = x.shape
    plan = ssd_chunk.ssd_plan(gs, length, h, sms)
    ws_n = 4 // plan.heads  # warps on one head, each a slice of the head dim
    y = np.zeros(x.shape)
    writes = np.zeros(x.shape, int)
    for cta in range(plan.ctas):
        g, row0, h0 = plan.work(cta)
        lo = 0 if seg is None else segment_start(seg, row0, length)
        tiles = range(lo // rt_n + late_start, row0 // rt_n + (0 if skip_diagonal else 1))
        rows = np.arange(row0, min(row0 + rt_n, length))
        acc = np.zeros((len(rows), h, p))
        for kt in tiles if lo >= 0 else ():
            keys = np.arange(kt * rt_n, min(kt * rt_n + rt_n, length))
            s = c[g, rows].astype(np.float64) @ b[g, keys].T.astype(np.float64)
            ok = keys[None] <= rows[:, None]
            if seg is not None:
                ok &= (seg[keys][None] == seg[rows][:, None]) & (seg[rows] >= 0)[:, None]
            for hh in range(h0, min(h0 + plan.heads, h)):
                decay = np.exp(np.where(ok, cum[g, keys, hh][None] - cum[g, rows, hh][:, None],
                                        0.0))
                att = np.where(ok, s * decay * dt[g, keys, hh][None], 0.0)
                acc[:, hh] += att @ x[g, keys, hh]
        for warp in range(4):
            hh = h0 + warp // ws_n
            cols = slice((warp % ws_n) * p // ws_n, (warp % ws_n + 1) * p // ws_n)
            if hh < h:
                y[g, rows, hh, cols] = acc[:, hh, cols]
                writes[g, rows, hh, cols] += 1
    return y, writes


SSD_WALK_CASES = {  # name: (groups, rows, segments or None)
    "chunk_256": (2, 256, None),
    "chunk_64": (3, 64, None),
    "chunk_16": (4, 16, None),
    "chunk_17": (2, 17, None),
    "chunk_100": (1, 100, None),
    "mixed": (1, 129, [0, 1, 2, 3] + [4] * 40 + [5] * 52 + [6] * 30 + [-1] * 3),
    "decode": (1, 8, list(range(8))),
    "long_segment": (1, 150, [2] * 5 + [7] * 120 + [1] * 9 + [-1] * 16),
    "padding": (1, 70, [0] * 20 + [-1] * 50),
}


def ssd_walk_inputs(name):
    groups, rows, seg = SSD_WALK_CASES[name]
    if seg is None:
        return [v.reshape(groups, *v.shape[2:])
                for v in ssd_chunk_inputs(1, groups, rows, 3, 16, 4, seed=rows)], None
    x, dt, cum, b, c, seg = ssd_segment_inputs(seg, h=3, p=16, n=4, seed=rows, a_max=16.0)
    return [v[None] for v in (x, dt, cum, b, c)], seg


def ssd_walk_want(a, seg):
    """The plain version of the walk's inputs, (G, L, H, P)."""
    t = [torch.from_numpy(v) for v in a]
    if seg is None:
        return ref.ssd_chunk_ref(*(v[None] for v in t))[0].numpy()
    return ref.ssd_segment_ref(*(v[0] for v in t), torch.from_numpy(seg))[None].numpy()


class TestSsdPlan:
    @pytest.mark.parametrize("name", list(SSD_WALK_CASES))
    @pytest.mark.parametrize("sms", [132, 8])
    def test_walk_matches_plain_version(self, name, sms):
        """The schedule (``ssd_plan``'s CTAs and map, warps' heads and
        head-dim slices, key tiles from each tile's start to its diagonal)
        writes every output element once and gives the plain version's
        result; K5's padding rows exact zeros.  At 8 SMs the plan takes
        groups of 4 heads (more than the 3 there are), at 132 the serving
        plans."""
        a, seg = ssd_walk_inputs(name)
        got, writes = walk_ssd(*a, seg=seg, sms=sms)
        assert (writes == 1).all()
        assert_close(got, ssd_walk_want(a, seg), "ssd_f32")
        if seg is not None:
            np.testing.assert_array_equal(got[0, np.asarray(seg) < 0], 0.0)

    @pytest.mark.parametrize("name,fault", [("mixed", "late_start"), ("long_segment", "late_start"),
                                            ("chunk_64", "skip_diagonal")])
    def test_walk_catches_planted_faults(self, name, fault):
        """A CTA that starts one key tile late (K5) or stops short of its
        diagonal (K6) changes rows by far more than ``TOL["ssd_f32"]``:
        the walk's key ranges are exactly what the sum needs."""
        a, seg = ssd_walk_inputs(name)
        kw = {"late_start": 1} if fault == "late_start" else {"skip_diagonal": True}
        got, _ = walk_ssd(*a, seg=seg, **kw)
        assert row_rel_err(got, ssd_walk_want(a, seg)) > 1e-2
