"""The port's hand-written kernels against their plain versions on the card,
in the working dtype (``TOL["kernel_bf16_gpu"]``).

Every test is marked ``gpu`` and skips without a CUDA device.  The file
imports neither ``jax`` nor ``repro`` (a GPU host need not have JAX), so
it runs there on its own:

    python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention, masked_accum, ops, ref, rmsnorm  # noqa: E402
from repro_torch.kernels import ssd_chunk  # noqa: E402
from test_torch_parity_util import (  # noqa: E402
    BF16_ULPS,
    K3_ROW_TOL,
    SSD_ROW_TOL,
    TOL,
    bf16_ulps,
    dscale_without_rows,
    np32,
    packed_scenario,
    quantize_pool,
    row_rel_err,
    skip_diagonal_tile_mask,
    skip_last_page,
    ssd_chunk_inputs,
    ssd_segment_inputs,
    ssd_skip_diagonal_tile_mask,
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

    @pytest.mark.parametrize("h,d,dtype", [(14, 64, torch.bfloat16), (16, 128, torch.float32)])
    def test_paged_attention_refuses_unserved_shapes(self, cuda, h, d, dtype):
        a = packed_scenario(page_size=16, kvh=2, h=h, d=d, seed=3)
        ta = {k: torch.from_numpy(v).to(cuda) for k, v in a.items()}
        for k in ("q", "k_pool", "v_pool"):
            ta[k] = ta[k].to(dtype)
        with pytest.raises((ValueError, TypeError)):
            flash_attention.paged_flash_attention(**ta)

    @pytest.mark.parametrize("rows", [8, 257])
    @pytest.mark.parametrize("model", [False, True])
    def test_rmsnorm(self, cuda, rows, model):
        rng = np.random.default_rng(rows)
        x = torch.from_numpy(rng.normal(size=(rows, 2048)).astype(np.float32))
        x = x.to(cuda, torch.bfloat16)
        s = torch.from_numpy((1 + 0.1 * rng.normal(size=2048)).astype(np.float32)).to(cuda)
        out = rmsnorm.rmsnorm(x, s, model=model)
        want = (ref.rmsnorm_model if model else ref.rmsnorm_ref)(x, s)
        assert bf16_ulps(out.cpu(), want.cpu()) <= BF16_ULPS
        xf = x.float()
        np.testing.assert_allclose(np32(rmsnorm.rmsnorm(xf, s, model=model)),
                                   np32(ref.rmsnorm_ref(xf, s)), atol=1e-5, rtol=1e-5)

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
                                                (16, 2, 96, torch.bfloat16),
                                                (16, 2, 128, torch.float32)])
    def test_flash_attention_refuses_unbuilt_shapes(self, cuda, h, kvh, sq, dtype):
        q, k, v, _ = attn_inputs(cuda, 1, sq, sq, seed=7, h=h, kvh=kvh)
        with pytest.raises((ValueError, TypeError)):
            flash_attention.flash_attention_fwd(q.to(dtype), k.to(dtype), v.to(dtype))

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

    # -----------------------------------------------------------------------
    # K6 / K5 at mamba2-130m's widths: 24 heads of 64, state 128, f32
    # -----------------------------------------------------------------------

    @pytest.mark.parametrize("bs,nc,l", [(8, 1, 256), (8, 2, 256), (8, 1, 64), (3, 1, 100),
                                         (1, 3, 1)])
    def test_ssd_chunk(self, cuda, bs, nc, l):
        """Full-width chunks (one and two a row), the serving run's 64-row
        steps, and lengths off the 64-row tile."""
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

    def test_ssd_checks_catch_planted_faults(self, cuda):
        """The row metric passes both kernels and fails a K6 that skips its
        diagonal 64-key tile and a K5 whose segment mask is dropped (the
        requests leak into each other)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        a = [torch.from_numpy(v).to(cuda) for v in ssd_chunk_inputs(8, 1, 256, 24, 64, 128, 1)]
        want = ref.ssd_chunk_ref(*a)
        bad = ref.ssd_chunk_ref(*a, mask=ssd_skip_diagonal_tile_mask(256, device=cuda))
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
