"""The port's hand-written kernels against their plain versions on the card,
in the working dtype (``TOL["kernel_bf16_gpu"]``), and the steps captured
as CUDA graphs against the same steps run eagerly (``disable_graphs()``).

Every test is marked ``gpu`` and skips without a CUDA device.  The file
imports neither ``jax`` nor ``repro`` (a GPU host need not have JAX), so
it runs there on its own:

    python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import contextlib
import dataclasses
import gc
from math import inf

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import core, graphs  # noqa: E402
from repro_torch.core import local_sgd  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention, masked_accum, ops, ref, rmsnorm  # noqa: E402
from repro_torch.kernels import ssd_chunk  # noqa: E402
from repro_torch.models import ModelConfig, model, moe  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.serve import ContinuousBatcher, Request  # noqa: E402
from test_torch_parity_util import (  # noqa: E402
    BF16_ULPS,
    K3_ROW_TOL,
    SSD_BWD_TOL,
    SSD_ROW_TOL,
    TOL,
    bf16_ulps,
    dscale_without_rows,
    load_smoke,
    norm_rel_err,
    np32,
    packed_scenario,
    quantize_pool,
    rmsnorm_model_ulps,
    rmsnorm_without_last_vector,
    row_rel_err,
    skip_diagonal_tile_mask,
    skip_last_page,
    ssd_chunk_inputs,
    ssd_segment_inputs,
    ssd_skip_diagonal_tile_mask,
    ulps16,
)


#: K2's backward against its plain version in bf16: the largest difference
#: over the largest magnitude of the plain result (every row of dx has the
#: same scale); dx is rounded once.  K3 is held row by row (``K3_ROW_TOL``).
REL_TOL = 2e-2


def rel_err(got, want) -> float:
    got, want = np32(got), np32(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def attn_inputs(cuda, b, sq, sk, seed, h=16, kvh=2, d=128):
    """bf16 q (B, H, Sq, D), k/v (B, KV, Sk, D) and dO, as transposed views
    of (B, S, heads, D) storage: the layout the model passes."""
    rng = np.random.default_rng(seed)

    def t(s, heads):
        x = torch.from_numpy(rng.normal(size=(b, s, heads, d)).astype(np.float32))
        return x.to(cuda, torch.bfloat16).transpose(1, 2)

    return t(sq, h), t(sk, kvh), t(sk, kvh), t(sq, h)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, PyTorch/CUDA port)")
    return torch.device("cuda")


@pytest.mark.gpu
class TestKernelsOnCard:
    @pytest.mark.parametrize("int8", [False, True])
    @pytest.mark.parametrize("window,softcap", [(0, 0.0), (7, 0.0), (0, 5.0)])
    @pytest.mark.parametrize("decode", [False, True], ids=["packed", "decode"])
    def test_paged_attention(self, cuda, int8, window, softcap, decode):
        """qwen2.5-3b's widths (16 heads over 2 KV heads, head dim 128).
        ``decode`` keeps one query per slot over long contexts: a grid of a
        few CTAs, whose block range the wrapper splits three ways or more,
        some splits empty for the shorter slots."""
        lens = (300, 40, 190) if decode else (40, 19, 33)
        a = packed_scenario(page_size=16, kvh=2, h=16, d=128, seed=3, lens=lens)
        if decode:  # each slot's last query, and a copy of the first to pad
            keep = np.r_[0, 0, 4, len(a["q_pos"]) - 1]
            a["q"], a["q_pos"], a["q_slots"] = (a[k][keep] for k in ("q", "q_pos", "q_slots"))
            splits, _ = flash_attention.split_blocks(
                2 * len(keep), a["tables"].shape[1], flash_attention._sm_count(0))
            assert splits >= 3
        a["tables"][1, 0] = -2  # hostile entry
        a["q_slots"][0] = -1  # padding query
        ta = {k: torch.from_numpy(v).to(cuda) for k, v in a.items()}
        for k in ("q", "k_pool", "v_pool"):
            ta[k] = ta[k].to(torch.bfloat16)
        if int8:
            for k in ("k", "v"):
                codes, scale = quantize_pool(np32(ta[f"{k}_pool"]))
                ta[f"{k}_pool"] = torch.from_numpy(codes).to(cuda)
                ta[f"{k}_scale"] = torch.from_numpy(scale).to(cuda)
        out = flash_attention.paged_flash_attention(**ta, window=window, softcap=softcap)
        want = ref.paged_attention_ref(**ta, window=window, softcap=softcap)
        torch.cuda.synchronize()
        np.testing.assert_allclose(np32(out), np32(want), **TOL["kernel_bf16_gpu"])
        assert (out[0] == 0).all()

    @pytest.mark.parametrize("int8", [False, True])
    def test_paged_attention_tiles_and_planted_fault(self, cuda, int8):
        """Prefill chunks longer than a tile (16 tokens) beside decode tokens:
        the step's plan passed in gives the wrapper's own result, bit for
        bit, within tolerance of the plain version; a kernel that skipped a
        tile's last page (``skip_last_page``, by the plain version) would
        fall outside it."""
        a = packed_scenario(page_size=16, kvh=2, h=16, d=128, seed=9, lens=(300, 70, 53))
        plan = flash_attention.paged_tile_plan(a["q_pos"], a["q_slots"], 16, a["tables"].shape[1])
        assert plan[:, 1].max() == flash_attention.TILE_TOKENS
        ta = {k: torch.from_numpy(v).to(cuda) for k, v in a.items()}
        for k in ("q", "k_pool", "v_pool"):
            ta[k] = ta[k].to(torch.bfloat16)
        if int8:
            for k in ("k", "v"):
                codes, scale = quantize_pool(np32(ta[f"{k}_pool"]))
                ta[f"{k}_pool"] = torch.from_numpy(codes).to(cuda)
                ta[f"{k}_scale"] = torch.from_numpy(scale).to(cuda)
        out = flash_attention.paged_flash_attention(**ta)
        again = flash_attention.paged_flash_attention(
            **ta, plan=torch.from_numpy(plan).to(cuda))
        want = ref.paged_attention_ref(**ta)
        bad = ref.paged_attention_ref(**skip_last_page(ta, plan[0]))
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        np.testing.assert_allclose(np32(out), np32(want), **TOL["kernel_bf16_gpu"])
        assert not np.allclose(np32(bad), np32(want), **TOL["kernel_bf16_gpu"])

    @pytest.mark.parametrize("int8", [False, True])
    @pytest.mark.parametrize("window,softcap", [(0, 0.0), (7, 0.0), (0, 5.0)])
    @pytest.mark.parametrize("decode", [False, True], ids=["packed", "decode"])
    def test_paged_attention_d256_g10(self, cuda, int8, window, softcap, decode):
        """recurrentgemma-2b's local attention (10 heads over 1 KV head, head
        dim 256): the instance with two n8 tiles of heads a token, Q in
        shared memory, tiles of 4 tokens and two CTAs an SM; ``decode`` as in
        ``test_paged_attention`` (the split merge loops over 2,560 (head,
        dim) pairs a CTA)."""
        inst = flash_attention.INSTANCES[256, 10]
        lens = (300, 40, 190) if decode else (40, 19, 33)
        a = packed_scenario(page_size=16, kvh=1, h=10, d=256, seed=4, lens=lens)
        if decode:
            keep = np.r_[0, 0, 4, len(a["q_pos"]) - 1]
            a["q"], a["q_pos"], a["q_slots"] = (a[k][keep] for k in ("q", "q_pos", "q_slots"))
            splits, _ = flash_attention.split_blocks(
                len(keep), a["tables"].shape[1], flash_attention._sm_count(0), inst.ctas_per_sm)
            assert splits >= 3
        else:
            plan = flash_attention.paged_tile_plan(a["q_pos"], a["q_slots"], 16,
                                                   a["tables"].shape[1], window, None,
                                                   inst.tile_tokens)
            assert plan[:, 1].max() == inst.tile_tokens == 4
        a["tables"][1, 0] = -2  # hostile entry
        a["q_slots"][0] = -1  # padding query
        ta = {k: torch.from_numpy(v).to(cuda) for k, v in a.items()}
        for k in ("q", "k_pool", "v_pool"):
            ta[k] = ta[k].to(torch.bfloat16)
        if int8:
            for k in ("k", "v"):
                codes, scale = quantize_pool(np32(ta[f"{k}_pool"]))
                ta[f"{k}_pool"] = torch.from_numpy(codes).to(cuda)
                ta[f"{k}_scale"] = torch.from_numpy(scale).to(cuda)
        out = flash_attention.paged_flash_attention(**ta, window=window, softcap=softcap)
        want = ref.paged_attention_ref(**ta, window=window, softcap=softcap)
        torch.cuda.synchronize()
        np.testing.assert_allclose(np32(out), np32(want), **TOL["kernel_bf16_gpu"])
        assert (out[0] == 0).all()
        assert (out[1:, 8:10] != 0).any()  # the second n8 tile's heads are written

    def test_paged_attention_d256_g10_planted_faults(self, cuda):
        """Both faults fail the tolerance: the kernel given zeros for heads
        8-9's queries (what a kernel whose second n8 tile read no Q computes),
        and the plain version with one split's blocks masked for one token
        (a merge that dropped that split's partial)."""
        inst = flash_attention.INSTANCES[256, 10]
        a = packed_scenario(page_size=16, kvh=1, h=10, d=256, seed=5, lens=(300, 40, 190))
        keep = np.r_[0, 4, len(a["q_pos"]) - 1]
        a["q"], a["q_pos"], a["q_slots"] = (a[k][keep] for k in ("q", "q_pos", "q_slots"))
        ta = {k: torch.from_numpy(v).to(cuda) for k, v in a.items()}
        for k in ("q", "k_pool", "v_pool"):
            ta[k] = ta[k].to(torch.bfloat16)
        want = ref.paged_attention_ref(**ta)
        q_cut = ta["q"].clone()
        q_cut[:, 8:10] = 0
        no_heads = flash_attention.paged_flash_attention(**dict(ta, q=q_cut))
        splits, per = flash_attention.split_blocks(len(keep), a["tables"].shape[1],
                                                   flash_attention._sm_count(0), inst.ctas_per_sm)
        assert splits >= 3
        tables = torch.cat([ta["tables"], ta["tables"][:1]])
        tables[-1, per:2 * per] = -1  # split 1 of slot 0's first query
        slots = ta["q_slots"].clone()
        slots[0] = tables.shape[0] - 1
        dropped = ref.paged_attention_ref(**dict(ta, tables=tables, q_slots=slots))
        torch.cuda.synchronize()
        for bad in (no_heads, dropped):
            assert not np.allclose(np32(bad), np32(want), **TOL["kernel_bf16_gpu"])

    @pytest.mark.parametrize("int8", [False, True])
    @pytest.mark.parametrize("window,softcap", [(0, 0.0), (7, 0.0), (0, 5.0)])
    @pytest.mark.parametrize("decode", [False, True], ids=["packed", "decode"])
    @pytest.mark.parametrize("h,kvh,d", [(32, 16, 128), (36, 4, 128), (48, 8, 128), (64, 4, 128),
                                         (14, 2, 64)],
                             ids=["d128_g2", "d128_g9", "d128_g6", "d128_g16", "d64_g7"])
    def test_paged_attention_d128_g2_g9(self, cuda, h, kvh, d, int8, window, softcap, decode):
        """gemma3-27b's and internlm2-1.8b's group of 2 (32 heads over 16 KV
        heads here: one n8 tile, heads 2-7 padding with zero queries, tiles
        of 8 tokens) and starcoder2-7b's group of 9 (36 over 4: two n8
        tiles, Q in shared memory, tiles of 4 tokens), and the MoE models':
        mixtral-8x22b's group of 6 (48 over 8, one n8 tile, heads 6-7
        padding) and qwen3-moe-235b-a22b's 16 (64 over 4, two full n8
        tiles), head dim 128; internvl2-1b's group of 7 at head dim 64 (14
        over 2: one n8 tile, head 7 padding, 64-byte int8 rows); ``decode``
        as in ``test_paged_attention``."""
        inst = flash_attention.INSTANCES[d, h // kvh]
        lens = (300, 40, 190) if decode else (40, 19, 33)
        a = packed_scenario(page_size=16, kvh=kvh, h=h, d=d, seed=6, lens=lens)
        if decode:
            keep = np.r_[0, 0, 4, len(a["q_pos"]) - 1]
            a["q"], a["q_pos"], a["q_slots"] = (a[k][keep] for k in ("q", "q_pos", "q_slots"))
            splits, _ = flash_attention.split_blocks(
                len(keep) * kvh, a["tables"].shape[1], flash_attention._sm_count(0),
                inst.ctas_per_sm)
            assert splits >= 2
        else:
            plan = flash_attention.paged_tile_plan(a["q_pos"], a["q_slots"], 16,
                                                   a["tables"].shape[1], window, None,
                                                   inst.tile_tokens)
            assert plan[:, 1].max() == inst.tile_tokens
        a["tables"][1, 0] = -2  # hostile entry
        a["q_slots"][0] = -1  # padding query
        ta = {k: torch.from_numpy(v).to(cuda) for k, v in a.items()}
        for k in ("q", "k_pool", "v_pool"):
            ta[k] = ta[k].to(torch.bfloat16)
        if int8:
            for k in ("k", "v"):
                codes, scale = quantize_pool(np32(ta[f"{k}_pool"]))
                ta[f"{k}_pool"] = torch.from_numpy(codes).to(cuda)
                ta[f"{k}_scale"] = torch.from_numpy(scale).to(cuda)
        out = flash_attention.paged_flash_attention(**ta, window=window, softcap=softcap)
        want = ref.paged_attention_ref(**ta, window=window, softcap=softcap)
        torch.cuda.synchronize()
        np.testing.assert_allclose(np32(out), np32(want), **TOL["kernel_bf16_gpu"])
        assert (out[0] == 0).all()
        g = h // kvh
        assert (out[1:].view(-1, kvh, g, d)[:, :, g - 1] != 0).any()  # the last head written

    @pytest.mark.parametrize("h,kvh,d", [(32, 16, 128), (36, 4, 128), (48, 8, 128), (64, 4, 128),
                                         (14, 2, 64)],
                             ids=["d128_g2", "d128_g9", "d128_g6", "d128_g16", "d64_g7"])
    def test_paged_attention_d128_g2_g9_planted_faults(self, cuda, h, kvh, d):
        """Both faults fail the tolerance: the kernel given zeros for the
        queries of each group's last n8 tile's heads (from head 1 at g 2, 6
        and 7, from head 8 at g 9 and 16), and the plain version with one
        split's blocks masked for one token (a merge that dropped that
        split's partial)."""
        g = h // kvh
        inst = flash_attention.INSTANCES[d, g]
        a = packed_scenario(page_size=16, kvh=kvh, h=h, d=d, seed=7, lens=(300, 40, 190))
        keep = np.r_[0, 4, len(a["q_pos"]) - 1]
        a["q"], a["q_pos"], a["q_slots"] = (a[k][keep] for k in ("q", "q_pos", "q_slots"))
        ta = {k: torch.from_numpy(v).to(cuda) for k, v in a.items()}
        for k in ("q", "k_pool", "v_pool"):
            ta[k] = ta[k].to(torch.bfloat16)
        want = ref.paged_attention_ref(**ta)
        q_cut = ta["q"].clone()
        q_cut.view(len(keep), kvh, g, d)[:, :, 8 if g > 8 else 1:] = 0
        no_heads = flash_attention.paged_flash_attention(**dict(ta, q=q_cut))
        splits, per = flash_attention.split_blocks(len(keep) * kvh, a["tables"].shape[1],
                                                   flash_attention._sm_count(0), inst.ctas_per_sm)
        assert splits >= 2
        tables = torch.cat([ta["tables"], ta["tables"][:1]])
        tables[-1, per:2 * per] = -1  # split 1 of slot 0's first query
        slots = ta["q_slots"].clone()
        slots[0] = tables.shape[0] - 1
        dropped = ref.paged_attention_ref(**dict(ta, tables=tables, q_slots=slots))
        torch.cuda.synchronize()
        for bad in (no_heads, dropped):
            assert not np.allclose(np32(bad), np32(want), **TOL["kernel_bf16_gpu"])

    @pytest.mark.parametrize("h,d,dtype", [(12, 64, torch.bfloat16), (16, 128, torch.float32)])
    def test_paged_attention_refuses_unserved_shapes(self, cuda, h, d, dtype):
        a = packed_scenario(page_size=16, kvh=2, h=h, d=d, seed=3)
        ta = {k: torch.from_numpy(v).to(cuda) for k, v in a.items()}
        for k in ("q", "k_pool", "v_pool"):
            ta[k] = ta[k].to(dtype)
        with pytest.raises((ValueError, TypeError)):
            flash_attention.paged_flash_attention(**ta)

    @pytest.mark.parametrize("rows,d", [(8, 2048), (257, 2048), (8192, 768), (8191, 768),
                                        (40000, 2048), (600, 29000)])
    @pytest.mark.parametrize("model", [False, True])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
    def test_rmsnorm(self, cuda, rows, d, model, dtype):
        """K2's forward against its plain version (f32 within 1e-5, bf16 and
        f16 within one ulp; in model mode a row whose inv is a tie may round
        it either way, ``rmsnorm_model_ulps``) at serving's and both
        trainings' shapes, a ring of stages refilled (40,000 x 2048) and
        rows a stage each (600 x 29,000; in f32 one slot); two runs
        bit-identical; a view one element off 16-byte alignment (the
        element-wise path) gives the aligned run's bits."""
        rng = np.random.default_rng(rows)
        x = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)).to(cuda, dtype)
        s = torch.from_numpy((1 + 0.1 * rng.normal(size=d)).astype(np.float32)).to(cuda)
        out = rmsnorm.rmsnorm(x, s, model=model)
        want = (ref.rmsnorm_model if model else ref.rmsnorm_ref)(x, s)
        if dtype == torch.float32:
            np.testing.assert_allclose(np32(out), np32(want), atol=1e-5, rtol=1e-5)
        elif model:
            assert rmsnorm_model_ulps(out, x, s)[0] <= BF16_ULPS
        else:
            assert ulps16(out, want) <= BF16_ULPS
        assert torch.equal(out, rmsnorm.rmsnorm(x, s, model=model))
        off = torch.empty(rows * d + 1, dtype=dtype, device=cuda)[1:].view(rows, d)
        off.copy_(x)
        assert off.data_ptr() % 16 != 0
        assert torch.equal(rmsnorm.rmsnorm(off, s, model=model), out)

    @pytest.mark.parametrize("model", [False, True])
    def test_rmsnorm_rows_alone_and_planted_fault(self, cuda, model):
        """At Mamba-2's micro-batch (8,192 x 768 bf16): rows 0..7 normalised
        alone are the same bits as in the whole call (a row's output depends
        on the row and the scale alone), and the planted fault (each row's
        last 16-byte vector out of its sum) fails the one-ulp check."""
        rng = np.random.default_rng(8192)
        x = torch.from_numpy(rng.normal(size=(8192, 768)).astype(np.float32))
        x = x.to(cuda, torch.bfloat16)
        s = torch.from_numpy((1 + 0.1 * rng.normal(size=768)).astype(np.float32)).to(cuda)
        out = rmsnorm.rmsnorm(x, s, model=model)
        assert torch.equal(rmsnorm.rmsnorm(x[:8], s, model=model), out[:8])
        bad = rmsnorm_without_last_vector(x, s, model=model)
        if model:
            assert rmsnorm_model_ulps(out, x, s)[0] <= BF16_ULPS
            assert rmsnorm_model_ulps(bad, x, s)[0] > BF16_ULPS
        else:
            want = ref.rmsnorm_ref(x, s)
            assert ulps16(out, want) <= BF16_ULPS and ulps16(bad, want) > BF16_ULPS

    @pytest.mark.parametrize("case", ["causal", "window", "segments", "right_aligned",
                                      "non_causal", "s64", "q64_k128", "b2_s2048",
                                      "window_mid_tile", "segments_mid_tile"])
    def test_flash_attention(self, cuda, case):
        """Forward (out, lse) and backward (dq, dk, dv) against the plain
        versions at qwen2.5-3b's head layout (16 heads over 2 KV heads,
        head dim 128).  The segment cases have queries whose segment no key
        shares: they return the mean of the TPU kernel's visited range.
        ``s64`` and ``q64_k128`` are shorter than one 128-row tile (the
        rest of the tile is padding); ``window_mid_tile`` puts the window's
        edge inside 128-key tiles and 64-row steps, ``segments_mid_tile``
        the segment boundaries."""
        b, sq, sk, causal, window = dict(
            causal=(2, 256, 256, True, 0), window=(1, 512, 512, True, 100),
            segments=(1, 256, 256, True, 0), right_aligned=(1, 128, 256, True, 0),
            non_causal=(1, 128, 128, False, 0), s64=(1, 64, 64, True, 0),
            q64_k128=(1, 64, 128, True, 0), b2_s2048=(2, 2048, 2048, True, 0),
            window_mid_tile=(1, 1024, 1024, True, 203),
            segments_mid_tile=(2, 512, 512, True, 0))[case]
        q, k, v, do = attn_inputs(cuda, b, sq, sk, seed=sq + sk)
        kw = dict(causal=causal, window=window)
        lonely = None
        if case in ("segments", "segments_mid_tile"):
            seg = np.zeros((b, sq), np.int32)
            cuts, lonely = (((100, 200), np.s_[:, :, 150:160]) if case == "segments"
                            else ((37, 190, 333), np.s_[:, :, 400:411]))
            for cut in cuts:
                seg[:, cut:] += 1
            qseg = seg.copy()
            qseg[:, lonely[2]] = 7  # no key has segment 7
            kw.update(q_segment_ids=torch.from_numpy(qseg).to(cuda),
                      kv_segment_ids=torch.from_numpy(seg).to(cuda))
        out, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
        want, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        assert out.stride() == q.stride()  # (B, S, H, D) storage, like q
        assert row_rel_err(out, want) <= K3_ROW_TOL
        if lonely is not None:
            assert np.abs(np32(want[lonely])).max() > 0  # the visited-range mean, not zeros
            assert row_rel_err(out[lonely], want[lonely]) <= K3_ROW_TOL
        np.testing.assert_allclose(np32(lse), np32(want_lse), atol=1e-3, rtol=0)
        grads = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        # on the kernel's own out and lse, as in chip_smoke.k3_checks: where one
        # key dominates a softmax, one bf16 ulp of O moves dq by more than dq
        wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        for name, got, w in zip(("dq", "dk", "dv"), grads, wants):
            assert got.shape == w.shape, name
            assert row_rel_err(got, w) <= K3_ROW_TOL, (name, row_rel_err(got, w))

    @pytest.mark.parametrize("b,h,s", [(16, 25, 128), (2, 16, 512)],
                             ids=["bert_1_5b", "bert_large_s512"])
    def test_flash_attention_bert(self, cuda, b, h, s):
        """The (head dim 64, group 1) bidirectional build at bert-1.5b's
        micro-batch (16 x 128 tokens, 25 heads) and bert-large's phase-2
        length (512 tokens, 16 heads): forward and backward against the
        plain versions row by row, two backward runs bit-identical (no
        atomics), and the causal flag, planted, outside the limit."""
        q, k, v, do = attn_inputs(cuda, b, s, s, seed=s + h, h=h, kvh=h, d=64)
        out, lse = flash_attention.flash_attention_fwd(q, k, v, causal=False)
        want, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=False)
        grads = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, causal=False)
        wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=False)
        again = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, causal=False)
        bad, _ = flash_attention.flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert row_rel_err(out, want) <= K3_ROW_TOL < row_rel_err(bad, want)
        np.testing.assert_allclose(np32(lse), np32(want_lse), atol=1e-3, rtol=0)
        for name, got, w in zip(("dq", "dk", "dv"), grads, wants):
            assert row_rel_err(got, w) <= K3_ROW_TOL, (name, row_rel_err(got, w))
        assert all(torch.equal(x, y) for x, y in zip(grads, again))

    @pytest.mark.parametrize("b,s,window", [(2, 512, 128), (1, 1024, 203), (1, 2048, 1000)],
                             ids=["s512_w128", "window_mid_tile", "s2048_w1000"])
    def test_flash_attention_d256_g10(self, cuda, b, s, window):
        """The (head dim 256, group 10) build at recurrentgemma-2b's head
        layout (10 heads on 1 KV head), causal with a sliding window: the
        window's edge within one 128-key tile (``s512_w128``), inside tiles
        and 64-row steps (``window_mid_tile``), and 16 key steps wide;
        forward and backward against the plain versions row by row, two
        backward runs bit-identical (no atomics), and the window dropped
        (``window=0``), planted, outside the limit."""
        q, k, v, do = attn_inputs(cuda, b, s, s, seed=s + window, h=10, kvh=1, d=256)
        kw = dict(causal=True, window=window)
        out, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
        want, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
        grads = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
        again = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        bad, _ = flash_attention.flash_attention_fwd(q, k, v, causal=True, window=0)
        torch.cuda.synchronize()
        assert out.stride() == q.stride()
        assert row_rel_err(out, want) <= K3_ROW_TOL < row_rel_err(bad, want)
        np.testing.assert_allclose(np32(lse), np32(want_lse), atol=1e-3, rtol=0)
        for name, got, w in zip(("dq", "dk", "dv"), grads, wants):
            assert got.shape == w.shape, name
            assert row_rel_err(got, w) <= K3_ROW_TOL, (name, row_rel_err(got, w))
        assert all(torch.equal(x, y) for x, y in zip(grads, again))

    @pytest.mark.parametrize("h,kvh,d,b,sq,sk,causal,window", [
        (6, 6, 64, 2, 1500, 1500, False, 0), (6, 6, 64, 4, 448, 448, True, 0),
        (6, 6, 64, 4, 448, 1500, False, 0), (6, 6, 64, 3, 100, 100, True, 0),
        (6, 6, 64, 2, 90, 200, False, 0),
        (16, 2, 128, 1, 1000, 1000, True, 0), (16, 2, 128, 2, 90, 90, True, 0),
        (10, 1, 256, 1, 8000, 8000, True, 2048), (10, 1, 256, 2, 1000, 1000, True, 700),
        (12, 2, 128, 1, 1000, 1000, True, 700),
        (32, 2, 128, 1, 1000, 1000, True, 0), (4, 2, 128, 2, 300, 300, True, 203),
        (18, 2, 128, 1, 1000, 1000, True, 0),
        (14, 2, 64, 4, 256 + 333, 256 + 333, True, 0), (14, 2, 64, 4, 256 + 470, 256 + 470, True, 0)],
        ids=["whisper_encoder", "whisper_decoder", "whisper_cross", "s100_causal",
             "s90_cross", "d128_g8_s1000", "d128_g8_s90", "d256_g10_s8000_window",
             "d256_g10_s1000_window", "d128_g6_s1000_window", "d128_g16_s1000", "d128_g2_s300_window", "d128_g9_s1000",
             "d64_g7_s589", "d64_g7_s726"])
    def test_flash_attention_ragged(self, cuda, h, kvh, d, b, sq, sk, causal, window):
        """Every (head dim, group) build at lengths off its tiles: the (64, 1)
        build with whisper-tiny's 6 heads at its encoder's 1,500 frames, its
        decoder's 448 tokens (causal), cross-attention 448 x 1,500, and
        lengths below 128 off 64; and each other build of ``TRAINED`` at
        its models' head counts over 1 or 2 KV heads, causal, at 1,000
        tokens (and 90 for qwen2.5-3b's), recurrentgemma-2b's at 8,000
        with its 2,048 window and at 1,000 with a window, mixtral-8x22b's and gemma3-27b's with a
        window, internvl2-1b's (64, 7) at two prefill lengths of its 256
        patch rows and a prompt.  Forward and backward against the plain versions row by
        row, two backward runs bit-identical, and two of ``chip_smoke.py``'s
        planted faults made through the schedule (its ``planted_plan``):
        the tail key tile's mask skipped (keys past Sk read as zeros: at
        1,500 keys they move a row's softmax ~2%, at the row limit, and its
        lse ~0.02, so the lse rejects it), and the last key tile's dK/dV
        dropped."""
        assert (d, h // kvh) in flash_attention.TRAINED
        smoke = load_smoke()
        q, k, v, do = attn_inputs(cuda, b, sq, sk, seed=sq + sk, h=h, kvh=kvh, d=d)
        kw = dict(causal=causal, window=window)
        fwd, bwd = flash_attention.flash_attention_fwd, flash_attention.flash_attention_bwd
        out, lse = fwd(q, k, v, **kw)
        want, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
        grads = bwd(q, k, v, out, lse, do, **kw)
        wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
        again = bwd(q, k, v, out, lse, do, **kw)
        with smoke.planted_plan(smoke.tail_mask_skipped):
            _, tail_lse = fwd(q, k, v, **kw)
        with smoke.planted_plan(smoke.last_key_tile_dropped):
            dropped = bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        assert out.stride() == q.stride()
        assert row_rel_err(out, want) <= K3_ROW_TOL
        np.testing.assert_allclose(np32(lse), np32(want_lse), atol=1e-3, rtol=0)
        for name, got, w in zip(("dq", "dk", "dv"), grads, wants):
            assert got.shape == w.shape, name
            assert row_rel_err(got, w) <= K3_ROW_TOL, (name, row_rel_err(got, w))
            assert bool(torch.isfinite(got.float()).all()), name
        assert all(torch.equal(x, y) for x, y in zip(grads, again))
        if sk % flash_attention.STEP:  # a partial tail tile: its zero keys must not count
            assert np.abs(np32(tail_lse) - np32(want_lse)).max() > 1e-3
        for got, w in zip(dropped[1:], wants[1:]):
            assert row_rel_err(got, w) > K3_ROW_TOL

    @pytest.mark.parametrize("h,kvh,b,s,window,d", [
        (48, 8, 1, 2048, 1000, 128), (64, 4, 1, 1024, 0, 128), (16, 8, 2, 512, 0, 128),
        (32, 16, 1, 1024, 203, 128), (36, 4, 1, 1024, 0, 128), (14, 2, 4, 2048, 0, 64)],
        ids=["g6_mixtral_window", "g16_qwen3_moe", "g2_internlm2", "g2_gemma3_window",
             "g9_starcoder2", "d64_g7_internvl2"])
    def test_flash_attention_trained_groups(self, cuda, h, kvh, b, s, window, d):
        """The builds at the groups the MoE, dense-zoo and VLM models train
        with (``TRAINED``): mixtral-8x22b's 48 heads over 8 (group 6,
        windowed), qwen3-moe's 64 over 4 (16), internlm2-1.8b's and
        gemma3-27b's group 2, starcoder2-7b's 36 over 4 (9) at head dim 128,
        and internvl2-1b's 14 over 2 (7) at head dim 64 on its training
        micro-batch (4 x 2,048); forward and backward against the plain
        versions row by row, two backward runs bit-identical, and planted
        faults outside the limit: the window dropped, or the causal mask;
        dK and dV summed over one query head of each group."""
        assert (d, h // kvh) in flash_attention.TRAINED
        q, k, v, do = attn_inputs(cuda, b, s, s, seed=h + s, h=h, kvh=kvh, d=d)
        kw = dict(causal=True, window=window)
        out, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
        want, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
        grads = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
        again = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        bad, _ = flash_attention.flash_attention_fwd(q, k, v, causal=bool(window), window=0)
        first = (torch.arange(h, device=cuda) % (h // kvh) == 0)[None, :, None, None]
        _, one_dk, one_dv = flash_attention.flash_attention_bwd(q, k, v, out, lse, do * first, **kw)
        torch.cuda.synchronize()
        assert row_rel_err(out, want) <= K3_ROW_TOL < row_rel_err(bad, want)
        np.testing.assert_allclose(np32(lse), np32(want_lse), atol=1e-3, rtol=0)
        for name, got, w in zip(("dq", "dk", "dv"), grads, wants):
            assert got.shape == w.shape, name
            assert row_rel_err(got, w) <= K3_ROW_TOL, (name, row_rel_err(got, w))
        assert all(torch.equal(x, y) for x, y in zip(grads, again))
        for got, w in zip((one_dk, one_dv), wants[1:]):
            assert row_rel_err(got, w) > K3_ROW_TOL

    def test_flash_attention_check_catches_a_planted_fault(self, cuda):
        """The row metric passes the kernel and fails what a kernel skipping
        its diagonal key tile for the later half of the rows would return
        (out, dq, dk and dv each)."""
        q, k, v, do = attn_inputs(cuda, 1, 1024, 1024, seed=8)
        out, lse = flash_attention.flash_attention_fwd(q, k, v)
        grads = flash_attention.flash_attention_bwd(q, k, v, out, lse, do)
        want, _ = ref.flash_attention_fwd_ref(q, k, v)
        wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, do)
        mask = skip_diagonal_tile_mask(1024, device=cuda)
        bad, bad_lse = ref.flash_attention_fwd_ref(q, k, v, mask=mask)
        bads = ref.flash_attention_bwd_ref(q, k, v, bad, bad_lse, do, mask=mask)
        for got, fault, w in zip((out, *grads), (bad, *bads), (want, *wants)):
            assert row_rel_err(got, w) <= K3_ROW_TOL < row_rel_err(fault, w)

    def test_flash_attention_backward_is_deterministic(self, cuda):
        q, k, v, do = attn_inputs(cuda, 1, 256, 256, seed=5)
        out, lse = flash_attention.flash_attention_fwd(q, k, v)
        a = flash_attention.flash_attention_bwd(q, k, v, out, lse, do)
        b = flash_attention.flash_attention_bwd(q, k, v, out, lse, do)
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    def test_flash_attention_autograd_counts(self, cuda):
        q, k, v, do = attn_inputs(cuda, 1, 128, 128, seed=6)
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        f0, b0 = flash_attention.flash_attention_fwd.launches, flash_attention.flash_attention_bwd.launches
        ops.flash_attention(q, k, v).backward(do)
        assert flash_attention.flash_attention_fwd.launches == f0 + 1
        assert flash_attention.flash_attention_bwd.launches == b0 + 1
        assert q.grad.shape == q.shape and k.grad.shape == k.shape

    @pytest.mark.parametrize("h,kvh,sq,dtype", [(14, 2, 128, torch.bfloat16),
                                                (16, 2, 0, torch.bfloat16),
                                                (16, 2, 128, torch.float32)])
    def test_flash_attention_refuses_unbuilt_shapes(self, cuda, h, kvh, sq, dtype):
        q, k, v, _ = attn_inputs(cuda, 1, sq, sq, seed=7, h=h, kvh=kvh)
        with pytest.raises((ValueError, TypeError)):
            flash_attention.flash_attention_fwd(q.to(dtype), k.to(dtype), v.to(dtype))

    @pytest.mark.parametrize("h,kvh,sq", [(16, 8, 128), (16, 16, 0)])
    def test_flash_attention_refuses_unbuilt_head_dim_64_shapes(self, cuda, h, kvh, sq):
        """Head dim 64 is built for groups 1 and 7 at lengths the kernels take."""
        q, k, v, _ = attn_inputs(cuda, 1, sq, sq, seed=7, h=h, kvh=kvh, d=64)
        with pytest.raises(flash_attention.UnbuiltShapeError):
            flash_attention.flash_attention_fwd(q, k, v, causal=False)

    @pytest.mark.parametrize("h,kvh,sq", [(8, 2, 128), (10, 1, 0)])
    def test_flash_attention_refuses_unbuilt_head_dim_256_shapes(self, cuda, h, kvh, sq):
        """Head dim 256 is built for group 10 at lengths the kernels take."""
        q, k, v, _ = attn_inputs(cuda, 1, sq, sq, seed=7, h=h, kvh=kvh, d=256)
        with pytest.raises(flash_attention.UnbuiltShapeError):
            flash_attention.flash_attention_fwd(q, k, v, window=64)

    @pytest.mark.parametrize("rows", [8, 2048, 257])
    @pytest.mark.parametrize("model", [False, True])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_rmsnorm_bwd(self, cuda, rows, model, dtype):
        rng = np.random.default_rng(rows)
        x = torch.from_numpy(rng.normal(size=(rows, 2048)).astype(np.float32)).to(cuda, dtype)
        dy = torch.from_numpy(rng.normal(size=(rows, 2048)).astype(np.float32)).to(cuda, dtype)
        s = torch.from_numpy((1 + 0.1 * rng.normal(size=2048)).astype(np.float32))
        s = s.to(cuda, dtype)
        dx, ds = rmsnorm.rmsnorm_bwd(x, s, dy, model=model)
        dx2, ds2 = rmsnorm.rmsnorm_bwd(x, s, dy, model=model)
        want_dx, want_ds = ref.rmsnorm_bwd_ref(x, s, dy, model=model)
        torch.cuda.synchronize()
        assert dx.dtype == x.dtype and ds.dtype == s.dtype
        assert torch.equal(dx, dx2) and torch.equal(ds, ds2)  # no atomics: bit-identical
        tol = REL_TOL if dtype == torch.bfloat16 else 1e-5
        assert rel_err(dx, want_dx) <= tol
        assert rel_err(ds, want_ds) <= tol
        if dtype == torch.float32:  # one CTA's rows left out of dscale must fail the check
            _, per, _, _ = rmsnorm.bwd_partition(rows, 2048, 4, rmsnorm._sm_count(0))
            assert rel_err(dscale_without_rows(x, s, dy, slice(0, per), model=model),
                           want_ds) > tol

    @pytest.mark.parametrize("d,dtype", [(100, torch.bfloat16), (2050, torch.float16),
                                         (4100, torch.float32)])
    def test_rmsnorm_bwd_unaligned_width(self, cuda, d, dtype):
        """Rows that are not a multiple of 16 bytes take the kernel's
        element-wise staging path; f32 scale beside 16-bit rows."""
        rng = np.random.default_rng(d)
        x, dy = (torch.from_numpy(rng.normal(size=(300, d)).astype(np.float32)).to(cuda, dtype)
                 for _ in range(2))
        s = torch.from_numpy((1 + 0.1 * rng.normal(size=d)).astype(np.float32)).to(cuda)
        for model in (False, True):
            dx, ds = rmsnorm.rmsnorm_bwd(x, s, dy, model=model)
            want_dx, want_ds = ref.rmsnorm_bwd_ref(x, s, dy, model=model)
            tol = REL_TOL if dtype != torch.float32 else 1e-5
            assert dx.dtype == dtype and ds.dtype == torch.float32
            assert rel_err(dx, want_dx) <= tol and rel_err(ds, want_ds) <= tol

    @pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("n", [4096, 65536 + 3])
    def test_masked_accum(self, cuda, gdtype, n):
        """Exact: keep and scale are powers of two, so keep * scale * grad
        is exact in f32 and the one rounding of the sum is the same."""
        rng = np.random.default_rng(n)
        acc = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
        g = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda, gdtype)
        for keep in (0.0, 1.0):
            for scale in (1.0, 0.125):
                want = ref.masked_accum_ref(acc, g, keep, scale)
                got = masked_accum.masked_accum(acc.clone(), g, keep, scale)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (keep, scale)
        kept = masked_accum.masked_accum(acc.clone(), g, 0.0)
        assert torch.equal(kept, acc)  # keep = 0 leaves the accumulator untouched

    @pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("n", [4096, 65536 + 3])
    def test_masked_accum_bf16(self, cuda, gdtype, n):
        """The bf16 accumulator (bf16 master parameters): the gradient
        rounded to bf16, the sum in f32, one rounding to bf16, equal to the
        plain version bit for bit; keep 0 leaves it untouched."""
        rng = np.random.default_rng(n + 1)
        acc = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda, torch.bfloat16)
        g = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda, gdtype)
        for keep in (0.0, 1.0):
            for scale in (1.0, 0.125):
                want = ref.masked_accum_ref(acc, g, keep, scale)
                got = masked_accum.masked_accum(acc.clone(), g, keep, scale)
                torch.cuda.synchronize()
                assert got.dtype == torch.bfloat16 and torch.equal(got, want), (keep, scale)
        assert torch.equal(masked_accum.masked_accum(acc.clone(), g, 0.0), acc)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            masked_accum.masked_accum(acc.half(), g, 1.0)

    @pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32])
    def test_masked_accum_local_step(self, cuda, gdtype):
        """K1 as the Local-SGD step, ``w += 1 * -lr * g``: the product is
        rounded, and the kernel may fuse it into the add (one rounding where
        the plain version has two): each element within half a spacing of
        the product plus half a spacing of each result (doubled across a
        binade edge), so two f32 spacings of the sum plus one of the
        product."""
        rng = np.random.default_rng(7)
        n = 65536 + 3
        w = torch.from_numpy(rng.normal(scale=0.02, size=n).astype(np.float32)).to(cuda)
        g = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda, gdtype)
        want = ref.masked_accum_ref(w, g, 1.0, -1e-4)
        got = masked_accum.masked_accum(w.clone(), g, 1.0, -1e-4)

        def spacing(t):
            t = t.abs()
            return torch.nextafter(t, torch.full_like(t, np.inf)) - t

        limit = 2 * spacing(want) + spacing(float(np.float32(-1e-4)) * g.float())
        assert bool(((got - want).abs() <= limit).all())
        assert not torch.equal(got, w)  # the step moved the weights

    # -----------------------------------------------------------------------
    # K6 / K5 at mamba2-130m's widths: 24 heads of 64, state 128, f32
    # -----------------------------------------------------------------------

    @pytest.mark.parametrize("bs,nc,l", [(8, 1, 256), (8, 2, 256), (8, 1, 64), (3, 1, 100),
                                         (1, 3, 1), (8, 1, 16), (2, 1, 17)])
    def test_ssd_chunk(self, cuda, bs, nc, l):
        """Full-width chunks (one and two a row), the serving run's 64-row
        and 16-row (decode) steps, and lengths off the 16-row tile."""
        torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
        a = [torch.from_numpy(v).to(cuda) for v in ssd_chunk_inputs(bs, nc, l, 24, 64, 128,
                                                                      seed=l + nc)]
        n0 = ssd_chunk.ssd_chunk.launches
        got = ssd_chunk.ssd_chunk(*a)
        want = ref.ssd_chunk_ref(*a)
        torch.cuda.synchronize()
        assert ssd_chunk.ssd_chunk.launches == n0 + 1
        assert bool(torch.isfinite(got).all())
        assert row_rel_err(got, want) <= SSD_ROW_TOL

    @pytest.mark.parametrize("seg", [
        [0] * 64 + [1] * 64 + [2] * 64 + [3] * 64 + [-1],  # the mixed packed step (T 257)
        list(range(8)),  # the packed decode step: one token for each of 8 slots
        [5] * 30 + [2] * 1 + [7] * 50 + [-1] * 19,  # ragged T 100
        [0] * 40 + [-1] * 90,  # a query tile without a segment: an empty key range
        [-1] * 70,  # nothing but padding
        [2] * 5 + [7] * 200 + [1] * 9 + [-1] * 43,  # a segment over 13 key tiles and 4 row blocks
    ])
    def test_ssd_segment(self, cuda, seg):
        torch.backends.cuda.matmul.allow_tf32 = False
        a = [torch.from_numpy(v).to(cuda) for v in ssd_segment_inputs(seg, 24, 64, 128,
                                                                        seed=len(seg), a_max=16.0)]
        n0 = ssd_chunk.ssd_segment.launches
        got = ssd_chunk.ssd_segment(*a)
        want = ref.ssd_segment_ref(*a)
        torch.cuda.synchronize()
        assert ssd_chunk.ssd_segment.launches == n0 + 1
        assert bool(torch.isfinite(got).all())
        assert row_rel_err(got, want) <= SSD_ROW_TOL
        pad = a[5] < 0
        assert (got[pad] == 0).all()  # padding rows: exact zeros

    def test_ssd_runs_are_bit_identical(self, cuda):
        """No atomics and a fixed order of sums: two runs agree bit for bit."""
        a = [torch.from_numpy(v).to(cuda) for v in ssd_chunk_inputs(8, 1, 256, 24, 64, 128, 3)]
        assert torch.equal(ssd_chunk.ssd_chunk(*a), ssd_chunk.ssd_chunk(*a))
        seg = [0] * 64 + [1] * 64 + [2] * 64 + [3] * 64 + [-1]
        s = [torch.from_numpy(v).to(cuda) for v in ssd_segment_inputs(seg, 24, 64, 128, 4)]
        assert torch.equal(ssd_chunk.ssd_segment(*s), ssd_chunk.ssd_segment(*s))

    def test_ssd_checks_catch_planted_faults(self, cuda):
        """The row metric passes both kernels and fails a K6 that skips its
        diagonal key tile (``ROW_TILE`` keys) and a K5 whose segment mask is
        dropped (the requests leak into each other)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        a = [torch.from_numpy(v).to(cuda) for v in ssd_chunk_inputs(8, 1, 256, 24, 64, 128, 1)]
        want = ref.ssd_chunk_ref(*a)
        bad = ref.ssd_chunk_ref(*a, mask=ssd_skip_diagonal_tile_mask(256, device=cuda,
                                                                    tile=ssd_chunk.ROW_TILE))
        assert row_rel_err(ssd_chunk.ssd_chunk(*a), want) <= SSD_ROW_TOL < row_rel_err(bad, want)
        seg = [0] * 64 + [1] * 64 + [2] * 64 + [3] * 64 + [-1]
        s = [torch.from_numpy(v).to(cuda) for v in ssd_segment_inputs(seg, 24, 64, 128, 2)]
        want = ref.ssd_segment_ref(*s)
        leak = ref.ssd_segment_ref(*s[:5], torch.where(s[5] >= 0, 0, s[5]))
        assert row_rel_err(ssd_chunk.ssd_segment(*s), want) <= SSD_ROW_TOL < row_rel_err(leak, want)

    def test_ssd_refuses_unbuilt_shapes(self, cuda):
        a = [torch.from_numpy(v).to(cuda) for v in ssd_chunk_inputs(1, 1, 64, 2, 32, 16, 0)]
        with pytest.raises(ssd_chunk.UnbuiltShapeError):
            ssd_chunk.ssd_chunk(*a)  # state 16, head dim 32
        b = [torch.from_numpy(v).to(cuda) for v in ssd_chunk_inputs(1, 1, 64, 2, 64, 128, 0)]
        with pytest.raises(ssd_chunk.UnbuiltShapeError):
            ssd_chunk.ssd_chunk(b[0].bfloat16(), *b[1:])

    # -----------------------------------------------------------------------
    # K6's backward at mamba2-130m's widths
    # -----------------------------------------------------------------------

    @staticmethod
    def ssd_bwd_inputs(cuda, bs, nc, l, seed, h=24):
        a = [torch.from_numpy(v).to(cuda) for v in ssd_chunk_inputs(bs, nc, l, h, 64, 128,
                                                                      seed=seed)]
        dy = torch.from_numpy(np.random.default_rng(seed + 1).normal(
            size=tuple(a[0].shape)).astype(np.float32)).to(cuda)
        return a, ssd_chunk.ssd_chunk(*a), dy

    @staticmethod
    def ssd_bwd_errs(got, want):
        """dx row by row, the other four relative to their norms."""
        return [row_rel_err(got[0], want[0])] + [norm_rel_err(g, w)
                                                 for g, w in zip(got[1:], want[1:])]

    @pytest.mark.parametrize("bs,nc,l,h", [(4, 2, 256, 24), (4, 1, 64, 24), (1, 3, 16, 24),
                                           (2, 2, 48, 3), (1, 2, 240, 5)])
    def test_ssd_chunk_bwd(self, cuda, bs, nc, l, h):
        """The training shape (256-row chunks), a 64-row and a 16-row chunk;
        chunks whose query tiles do not split evenly over the key-tile CTA's
        4 warps (3 and 15 tiles) with 3 and 5 heads; one launch counted a
        call."""
        torch.backends.cuda.matmul.allow_tf32 = False
        a, y, dy = self.ssd_bwd_inputs(cuda, bs, nc, l, seed=l + nc, h=h)
        n0 = ssd_chunk.ssd_chunk_bwd.launches
        got = ssd_chunk.ssd_chunk_bwd(*a, y, dy)
        want = ref.ssd_chunk_bwd_ref(*a, dy)
        torch.cuda.synchronize()
        assert ssd_chunk.ssd_chunk_bwd.launches == n0 + 1
        assert all(bool(torch.isfinite(g).all()) for g in got)
        errs = self.ssd_bwd_errs(got, want)
        assert max(errs) <= SSD_BWD_TOL, errs

    def test_ssd_chunk_bwd_runs_are_bit_identical(self, cuda):
        """No atomics, the sums over the heads in a fixed order."""
        a, y, dy = self.ssd_bwd_inputs(cuda, 4, 2, 256, seed=9)
        one, two = ssd_chunk.ssd_chunk_bwd(*a, y, dy), ssd_chunk.ssd_chunk_bwd(*a, y, dy)
        assert all(torch.equal(p, q) for p, q in zip(one, two))

    def test_ssd_chunk_bwd_checks_catch_planted_faults(self, cuda):
        """The same metrics fail the plain backward with the diagonal key tile
        left out (of dB among the rest) and with dcum's row part dropped."""
        torch.backends.cuda.matmul.allow_tf32 = False
        a, y, dy = self.ssd_bwd_inputs(cuda, 2, 2, 256, seed=4)
        want = ref.ssd_chunk_bwd_ref(*a, dy)
        got = ssd_chunk.ssd_chunk_bwd(*a, y, dy)
        assert max(self.ssd_bwd_errs(got, want)) <= SSD_BWD_TOL
        skip = ssd_skip_diagonal_tile_mask(256, device=cuda, tile=ssd_chunk.ROW_TILE)
        bad = ref.ssd_chunk_bwd_ref(*a, dy, mask=skip)
        assert norm_rel_err(bad[3], want[3]) > SSD_BWD_TOL
        assert norm_rel_err(want[2] + (dy * y).sum(-1), want[2]) > SSD_BWD_TOL

    def test_ssd_chunk_fn_counts_one_backward_launch(self, cuda):
        """``ops.ssd_chunk`` under autograd: one forward and one backward
        launch, the gradients those of the wrapper called directly."""
        a, y, dy = self.ssd_bwd_inputs(cuda, 2, 2, 256, seed=5)
        leaves = [t.clone().requires_grad_() for t in a]
        f0, b0 = ssd_chunk.ssd_chunk.launches, ssd_chunk.ssd_chunk_bwd.launches
        out = ops.ssd_chunk(*leaves)
        out.backward(dy)
        assert ssd_chunk.ssd_chunk.launches == f0 + 1
        assert ssd_chunk.ssd_chunk_bwd.launches == b0 + 1
        assert torch.equal(out.detach(), y)
        for leaf, w in zip(leaves, ssd_chunk.ssd_chunk_bwd(*a, y, dy)):
            assert torch.equal(leaf.grad, w)

    def test_ssd_chunk_bwd_refuses_unbuilt_shapes(self, cuda):
        """Chunks off the 16-row tile or above 256 rows, and state 16."""
        for l in (17, 512):
            a, y, dy = self.ssd_bwd_inputs(cuda, 1, 1, l, seed=0)
            with pytest.raises(ssd_chunk.UnbuiltShapeError, match="chunk length"):
                ssd_chunk.ssd_chunk_bwd(*a, y, dy)
        s = [torch.from_numpy(v).to(cuda) for v in ssd_chunk_inputs(1, 1, 64, 2, 32, 16, 0)]
        with pytest.raises(ssd_chunk.UnbuiltShapeError):
            ssd_chunk.ssd_chunk_bwd(*s, s[0], s[0])


def two_layers(name, cuda):
    """A model at its published widths with 2 layers (random weights, seed 0),
    drawn after the earlier tests' engines are collected (a captured
    engine's graphs and their pool keep it alive until then)."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(name), n_layers=2)
    return cfg, model.init_params(cfg, seed=0, device=cuda)


@pytest.mark.gpu
class TestGraphsOnCard:
    @pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
    @pytest.mark.parametrize("cache", ["dense", "paged"])
    @pytest.mark.parametrize("name", ["qwen2_5_3b", "mamba2_130m", "internlm2_1_8b",
                                      "starcoder2_7b", "gemma3_27b", "mixtral_8x22b",
                                      "qwen3_moe_235b_a22b", "internvl2_1b"])
    def test_graphed_streams_equal_eager(self, cuda, name, cache, packed):
        """The engine's steps captured as CUDA graphs (the default on the
        card) serve the eager engine's greedy streams, launch the same
        kernels, and capture one graph per step shape."""
        cfg, params = two_layers(name, cuda)
        params = model.compute_params(params, cfg)
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 17, 70, 5, 33)]

        def serve():
            eng = ContinuousBatcher(params, cfg, batch_slots=4, max_len=128, chunk_size=16,
                                    token_budget=40, cache=cache, page_size=16, packed=packed)
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
            ops.reset_launch_counts()
            eng.run()
            torch.cuda.synchronize()
            return {u: r.output for u, r in eng.finished.items()}, ops.launch_counts(), eng

        with graphs.disable_graphs():
            want, want_counts, _ = serve()
        got, got_counts, eng = serve()
        assert got == want and len(got) == len(prompts)
        assert got_counts == want_counts
        assert len(eng.step_graph.keys) == 2  # a mixed and a decode shape

    @pytest.mark.parametrize("eager", [False, True])
    def test_completed_fraction_is_the_exact_quotient(self, cuda, eager):
        """46 of 48 micro-batches kept (bert-1.5b's 4 workers x 12): the
        completed fraction is the correctly rounded f32 quotient, not an ulp
        off as a CUDA tensor divided by a Python number is."""
        params = {"w": torch.ones(4, device=cuda)}
        grad = core.make_grad_fn(
            lambda p, mb: ((p["w"] * mb["x"]).sum(), torch.ones((), device=cuda)))
        mask = np.ones(48, np.float32)
        mask[[5, 40]] = 0
        with (graphs.disable_graphs() if eager else contextlib.nullcontext()):
            _, _, stats = core.accumulate_grads(grad, params, {"x": torch.ones(48, 4, device=cuda)},
                                                mask, core.DropConfig())
        assert float(stats["completed_fraction"]) == float(np.float32(46) / np.float32(48))

    def test_graphed_microbatch_equals_eager(self, cuda):
        """One training step of three micro-batches, the middle one dropped:
        graphed (a capture, then a replay) and eager give the same loss and
        the same gradient leaves, bit for bit, and the same launches."""
        cfg, params = two_layers("qwen2_5_3b", cuda)
        compute = model.train_params(params, cfg)
        grad = core.make_grad_fn(lambda p, mb: model.loss_fn(p, cfg, mb))
        rng = np.random.default_rng(2)
        mbs = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1, 256))).to(cuda),
               "weights": torch.ones((3, 1, 256), device=cuda)}

        def run():
            acc = core.Accumulator(grad, compute)
            ops.reset_launch_counts()
            g, loss, _ = core.accumulate_grads(grad, compute, mbs, [1, 0, 1], core.DropConfig(),
                                               accumulator=acc)
            return [x.clone() for x in tree_leaves(g)], float(loss), ops.launch_counts(), acc

        with graphs.disable_graphs():
            want, want_loss, want_counts, _ = run()
        got, loss, counts, acc = run()
        assert len(acc.step_graph.keys) == 1
        assert loss == want_loss
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert counts == want_counts

    def test_graphed_localsgd_equals_eager(self, cuda):
        """Two Local-SGD rounds of 2 workers x 2 local steps, one step
        dropped: graphed (a kept-step and a dropped-step graph) and eager
        give the same round losses and averaged parameters, bit for bit, and
        the same launches; K1 adds each leaf once a kept step and once a
        worker (S += W)."""
        cfg, _ = two_layers("qwen2_5_3b", cuda)
        rng = np.random.default_rng(3)
        tokens = rng.integers(0, cfg.vocab_size, (2, 2, 2, 1, 256))
        keep = np.array([[[1, 0], [1, 1]], [[1, 1], [1, 1]]], np.float32)

        def loss(p, mb):
            ls, w = model.loss_fn(p, cfg, mb)
            return ls / w

        def run():
            params = model.init_params(cfg, seed=0, device=cuda)
            ops.reset_launch_counts()
            p, losses = local_sgd.localsgd_train(
                loss, params, lambda r, n: {"tokens": tokens[r, n]}, 2, 2, 2, 1e-3,
                keep_mask=keep, cast=lambda w, out=None: model.train_params(w, cfg, out=out))
            return [x.clone() for x in tree_leaves(p)], losses, ops.launch_counts()

        with graphs.disable_graphs():
            want, want_losses, want_counts = run()
        got, losses, counts = run()
        assert losses == want_losses
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert counts == want_counts
        assert counts["masked_accum"] == len(got) * (7 + 4)


#: GUMBEL_TOL of tests/test_torch_sampling.py: each ``log`` of the Gumbel
#: draw may differ by an ulp between libraries (CUDA's against the CPU's)
GUMBEL_TOL = dict(atol=2.0 ** -20, rtol=2.0 ** -21)
#: chip_smoke.py's LOGITS_REL_TOL: paged (K4) against dense (plain) logits
LOGITS_REL_TOL = 0.03


@pytest.mark.gpu
class TestDecodeAndSamplingOnCard:
    @pytest.mark.parametrize("v", [503, 151_936])
    def test_sampler_matches_the_cpu_port(self, cuda, v):
        """The sampler on the card: the PRNG words equal the CPU port's bit
        for bit (the CPU port is held to ``jax.random`` by
        test_torch_sampling.py), the Gumbel draws within GUMBEL_TOL, and the
        tokens of every program equal the CPU port's."""
        from repro_torch.serve import sampling

        rng = np.random.default_rng(v)
        lg = torch.from_numpy(rng.normal(size=(8, v)).astype(np.float32) * 3)
        seeds = np.asarray([0, 2**32 - 1, 1, 7, 12345, 2**31, 99, 3], np.int64)
        oidx = np.asarray([0, 1, 2**20, 5, 31, 1000, 2**19, 17], np.int64)
        keys = [sampling.fold_in(sampling.prng_key(torch.from_numpy(seeds).to(d)),
                                 torch.from_numpy(oidx).to(d)) for d in (cuda, "cpu")]
        words = [sampling.random_bits(k, v) for k in keys]
        assert torch.equal(words[0].cpu(), words[1])
        np.testing.assert_allclose(sampling.gumbel_from_bits(words[0]).cpu().numpy(),
                                   sampling.gumbel_from_bits(words[1]).numpy(), **GUMBEL_TOL)
        for t, k, p in [(0.0, 0, 1.0), (0.9, 0, 1.0), (0.7, 50, 1.0), (1.3, 0, 0.9),
                        (0.8, 50, 0.95), (1.0, 1, 1e-6)]:
            rows = (seeds, oidx, np.full(8, t, np.float32), np.full(8, k, np.int64),
                    np.full(8, p, np.float32))
            rows[2][3] = 0.0
            mode = sampling.sample_mode(*rows[2:])
            got = sampling.sample_rows(lg.to(cuda), *sampling.sampler_inputs(*rows, device=cuda),
                                       mode)
            want = sampling.sample_rows(lg, *sampling.sampler_inputs(*rows), mode)
            assert torch.equal(got.cpu(), want), (t, k, p)

    @pytest.mark.parametrize("name,layers", [("qwen2_5_3b", 2), ("recurrentgemma_2b", 3),
                                             ("internlm2_1_8b", 2), ("starcoder2_7b", 2),
                                             ("gemma3_27b", 2)])
    def test_paged_decode_step_matches_dense(self, cuda, name, layers):
        """``decode_step`` through ``make_serve_step`` at the published widths:
        paged (K4) against the dense layout (plain attention; recurrentgemma's
        on its ring) within LOGITS_REL_TOL at every step, and its graphed
        steps equal to the eager steps bit for bit."""
        from repro_torch.launch import steps
        from repro_torch.serve import KVCacheSpec

        cfg = dataclasses.replace(get_config(name), n_layers=layers)
        params = model.compute_params(model.init_params(cfg, seed=0, device=cuda), cfg)
        n, max_len = 3, 96
        rng = np.random.default_rng(4)
        seqs = rng.integers(0, cfg.vocab_size, (n, max_len))
        offsets = np.asarray([0, 7, 30])

        def caches():
            kv = KVCacheSpec(num_slots=n, max_len=max_len, layout="paged",
                             page_size=16).build(params, cfg)
            for i in range(n):
                assert kv.admit_slot(i, list(range(max_len - 1)), 1) == 0
                kv.prepare_write(i, 0, max_len)
            return {"paged": kv.state, "dense": model.init_decode_cache(params, cfg, n, max_len)}

        def run(eager):
            cs = caches()
            serve = {k: steps.make_serve_step(cfg) for k in cs}
            out = []
            with (graphs.disable_graphs() if eager else contextlib.nullcontext()):
                for t in range(max_len - offsets.max()):
                    pos = offsets + t
                    tok = seqs[np.arange(n), pos][:, None]
                    for k in cs:
                        serve[k](params, cs[k], tok, pos)
                    out.append({k: serve[k].logits.clone() for k in cs})
            return out

        eager, graphed = run(True), run(False)
        for e, g in zip(eager, graphed):
            assert all(torch.equal(e[k], g[k]) for k in e)
            gap = (g["paged"].float() - g["dense"].float()).abs().max()
            assert float(gap) <= LOGITS_REL_TOL * float(g["dense"].float().abs().max())

    @pytest.mark.parametrize("proposer", ["none", "ngram", "self-draft"])
    def test_sampled_and_speculative_streams_graphed_equal_eager(self, cuda, proposer):
        """Sampled requests (mixed with greedy ones), with and without
        speculation, on the paged engine: the graphed streams equal the eager
        ones, no page leaks, and each step launches one K4 a layer."""
        from repro_torch.serve import (DraftModelProposer, NGramProposer, SamplingParams,
                                       SpecConfig)

        cfg, params = two_layers("qwen2_5_3b", cuda)
        params = model.compute_params(params, cfg)
        rng = np.random.default_rng(6)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 17, 70, 5)]

        def serve():
            spec = {"none": None, "ngram": SpecConfig(NGramProposer(), k=4),
                    "self-draft": SpecConfig(DraftModelProposer(params, cfg, 4, 128), k=4)}[proposer]
            eng = ContinuousBatcher(params, cfg, batch_slots=4, max_len=128, chunk_size=16,
                                    token_budget=40, cache="paged", page_size=16, spec=spec)
            for i, p in enumerate(prompts):
                sp = SamplingParams() if i == 1 else SamplingParams(
                    temperature=0.8, top_p=0.95, top_k=50 if i == 2 else 0, seed=i)
                eng.submit(Request(uid=i, prompt=p, max_new_tokens=12, sampling=sp))
            ops.reset_launch_counts()
            eng.run()
            torch.cuda.synchronize()
            eng.kv.check_invariants()
            assert eng.kv.used_pages == 0
            assert ops.launch_counts()["paged_attention"] == cfg.n_layers * eng.steps
            return {u: r.output for u, r in eng.finished.items()}

        with graphs.disable_graphs():
            want = serve()
        assert serve() == want and all(len(v) == 12 for v in want.values())


def moe_layer(cuda, n_experts, top_k, d=512, f=256, seed=0):
    """An MoE layer (bf16 compute, f32 router) and bf16 inputs (4 x 64 x d)
    on the card."""
    cfg = ModelConfig(d_model=d, n_experts=n_experts, top_k=top_k, moe_d_ff=f,
                      dtype="bfloat16", param_dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(seed)
    p = moe.init_moe(gen, cfg, device=cuda)
    p["router"] = p["router"].float()
    x = torch.randn(4, 64, d, generator=gen, device=cuda).to(torch.bfloat16)
    return cfg, p, x


@pytest.mark.gpu
class TestMoEOnCard:
    @pytest.mark.parametrize("n_experts,top_k", [(8, 2), (128, 8)], ids=["top2of8", "top8of128"])
    def test_dispatch_forms_agree(self, cuda, n_experts, top_k):
        """mixtral's and qwen3-moe's routing shapes: the capacity form at cf
        inf against the dense form (within the kernel tolerance; the two
        multiply the same (E, t, d) shapes and combine alike, so equal bits
        are expected); at cf 0.5 and 1.25 the overflow equals a plain
        recount from the router's ids, and the dense form on the card
        against the CPU's on the same inputs."""
        cfg, p, x = moe_layer(cuda, n_experts, top_k)
        yd, _ = moe.apply_moe_dense(p, x, cfg)
        yi, _, ovf = moe.apply_moe_capacity(p, x, dataclasses.replace(cfg, capacity_factor=inf))
        assert int(ovf) == 0
        np.testing.assert_allclose(np32(yi), np32(yd), **TOL["kernel_bf16_gpu"])
        assert torch.equal(yi, yd)
        t = x.shape[0] * x.shape[1]
        _, ids, _ = moe._router(p, x.reshape(t, -1), cfg)
        counts = torch.bincount(ids.reshape(-1), minlength=n_experts).cpu().numpy()
        for cf in (0.5, 1.25):
            c = dataclasses.replace(cfg, capacity_factor=cf)
            _, _, ovf = moe.apply_moe_capacity(p, x, c)
            assert int(ovf) == int(np.maximum(counts - moe.capacity(c, t), 0).sum())
        cpu_p = {k: v.cpu() for k, v in p.items()}
        yc, _ = moe.apply_moe_dense(cpu_p, x.cpu(), cfg)
        assert row_rel_err(np32(yd), np32(yc)) < 2e-2

    def test_dispatch_is_deterministic_and_graphs(self, cuda):
        """The capacity form twice gives the same bits, and captured in a
        CUDA graph its replay gives the eager call's bits."""
        cfg, p, x = moe_layer(cuda, 128, 8)
        c = dataclasses.replace(cfg, capacity_factor=1.25)
        a = moe.apply_moe_capacity(p, x, c)[0]
        assert torch.equal(a, moe.apply_moe_capacity(p, x, c)[0])
        step = graphs.StepGraph(lambda x_: moe.apply_moe_capacity(p, x_, c)[0], x.device)
        step("k", x)  # the warm-up and capture
        assert torch.equal(step("k", x), a)

    @pytest.mark.parametrize("impl", ["sort", "capacity", "dense"])
    def test_backward_is_deterministic(self, cuda, impl):
        """Two backward passes of the MoE layer (mixtral's top-2 of 8, cf
        0.5: routes dropped) give the same bits for x and every parameter:
        no scatter of the backward has a repeated index."""
        cfg, p, x = moe_layer(cuda, 8, 2)
        cfg = dataclasses.replace(cfg, capacity_factor=0.5)
        cot = torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(1),
                          device=cuda).to(x.dtype)
        runs = []
        for _ in range(2):
            leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
            xx = x.detach().clone().requires_grad_()
            y, aux, _ = moe.apply_moe(leaves, xx, cfg, impl=impl)
            (torch.sum(y.float() * cot.float()) + aux).backward()
            runs.append([xx.grad] + [leaves[k].grad for k in sorted(leaves)])
        torch.cuda.synchronize()
        assert all(g is not None and torch.equal(a, g) for a, g in zip(*runs))

    @pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
    @pytest.mark.parametrize("name", ["mixtral_8x22b", "qwen3_moe_235b_a22b"])
    def test_capacity_engine_graphed_equals_eager(self, cuda, name, packed):
        """A 2-layer full-width MoE model served paged at the config's
        capacity factor: graphed streams and each step's overflow equal to
        the eager run's, some routes dropped."""
        cfg, params = two_layers(name, cuda)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 17, 70, 5, 33)]

        def serve():
            eng = ContinuousBatcher(params, cfg, batch_slots=4, max_len=128, chunk_size=16,
                                    token_budget=40, cache="paged", page_size=16, packed=packed,
                                    capacity_factor=cfg.capacity_factor)
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
            eng.run()
            return ({u: r.output for u, r in eng.finished.items()},
                    [st.expert_overflow for st in eng.step_stats])

        with graphs.disable_graphs():
            want = serve()
        got = serve()
        assert got == want and len(got[0]) == len(prompts)
        assert sum(got[1]) > 0
