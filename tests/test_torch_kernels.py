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
and fed to both packages.
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
    K3_ROW_TOL,
    TOL,
    assert_close,
    bf16_ulps,
    packed_scenario,
    quantize_pool,
    row_rel_err,
    skip_diagonal_tile_mask,
    ssd_chunk_inputs,
    ssd_segment_inputs,
    ssd_skip_diagonal_tile_mask,
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
                               "flash_attention_bwd", "masked_accum", "ssd_chunk", "ssd_segment"}
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

    @pytest.mark.parametrize("tiles,heads,want", [
        (32, 24, 4),  # K6 at B 8, L 256: 192 CTAs of 4 heads
        (8, 24, 1),  # K6 at B 8, L 64 (a decode or 64-token step): 192 CTAs of one head
        (5, 24, 1),  # K5 at T 257: 120 CTAs, the most it can have
        (16, 24, 2),  # 192 CTAs of 2 heads
    ])
    def test_ssd_heads_per_cta(self, tiles, heads, want):
        assert ssd_chunk.heads_per_cta(tiles, heads, 132) == want

    def test_ssd_refuses_unbuilt_shapes(self):
        ssd_chunk.require_built(128, 64)
        for n, p, dtype in ((16, 64, torch.float32), (128, 32, torch.float32),
                            (128, 64, torch.bfloat16)):
            with pytest.raises(ssd_chunk.UnbuiltShapeError):
                ssd_chunk.require_built(n, p, dtype)

    def test_rmsnorm_block_shape(self):
        assert rmsnorm.block_shape(2048) == (4, 2048, 8)
        assert rmsnorm.block_shape(128) == (64, 128, 4)
        assert rmsnorm.block_shape(100)[1] == 128


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


def test_ssd_ctypes_signature_matches_the_cuda_source(monkeypatch):
    class Fn:
        pass

    class Lib:
        repro_ssd = Fn()

    monkeypatch.setattr(ssd_chunk._build, "load", lambda source: Lib)
    assert _c_argtypes(ssd_chunk.SOURCE, "repro_ssd") == ssd_chunk.load_library().repro_ssd.argtypes


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
