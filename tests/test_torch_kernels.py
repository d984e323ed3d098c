"""The port's kernels: plain versions against the JAX references on the CPU,
and device dispatch.  The CUDA/Triton kernels themselves are held to their
plain versions on the card by ``test_torch_kernels_gpu.py``.

Mirrors ``tests/test_kernels.py:140-355``: paged attention with windows,
softcap, int8 scales, hostile block tables, padding and fully masked
queries; RMSNorm in the kernel's f32 mode and in ``apply_norm``'s mode.
Inputs are made with numpy from a seed and fed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import ModelConfig as JConfig  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels import flash_attention, ops, ref, rmsnorm  # noqa: E402
from test_torch_parity_util import (  # noqa: E402
    BF16_ULPS,
    TOL,
    assert_close,
    bf16_ulps,
    packed_scenario,
    quantize_pool,
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
        assert ops.launch_counts() == {"paged_attention": 0, "rmsnorm": 0}

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        a = {k: torch.from_numpy(v) for k, v in packed_scenario(seed=2).items()}
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention.paged_flash_attention(**a)
        with pytest.raises(ValueError, match="CUDA"):
            rmsnorm.rmsnorm(torch.ones(2, 8), torch.ones(8))

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

    def test_rmsnorm_block_shape(self):
        assert rmsnorm.block_shape(2048) == (4, 2048, 8)
        assert rmsnorm.block_shape(128) == (64, 128, 4)
        assert rmsnorm.block_shape(100)[1] == 128


def test_tolerance_table_is_shared():
    """One table for every port test file (later slices extend it)."""
    assert {"kernel_f32", "norm_f32", "model_f32", "kernel_bf16_gpu"} <= set(TOL)


def test_ctypes_signature_matches_the_cuda_source():
    """The wrapper's argtypes must list exactly the C entry point's
    parameters, pointer for pointer (a miscount only shows on the card)."""
    import re

    src = (flash_attention._build.KERNEL_DIR / flash_attention.SOURCE).read_text()
    sig = re.search(r'extern "C" int repro_paged_attention\((.*?)\)\s*\{', src, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    kinds = ["p" if "*" in p else ("f" if p.startswith("float") else "i") for p in params]
    import ctypes

    want = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    assert [want[k] for k in kinds] == flash_attention._ARGTYPES
