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

from repro_torch.kernels import flash_attention, ref, rmsnorm  # noqa: E402
from test_torch_parity_util import (  # noqa: E402
    BF16_ULPS,
    TOL,
    bf16_ulps,
    np32,
    packed_scenario,
    quantize_pool,
)


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
