"""Shared parity helpers for the PyTorch port's tests: the one tolerance
table every ``test_torch_*`` file uses, the numpy bridges between the two
packages, and the seeded paged-attention scenarios the CPU and the card
tests share.  It imports no JAX, so the card's tests can use it.

Tolerances (``TOL``), each with its reason:

* ``kernel_f32`` — a plain kernel version against the JAX reference on the
  CPU in f32: the same math in another summation order, ~1e-6 apart.
* ``norm_f32`` — RMSNorm in f32 on the CPU: a mean and an rsqrt, ~1e-7.
* ``model_f32`` — prefill logits and cache rows of a small f32 model:
  a few layers of matmuls in another order; logits of O(1-10).
* ``kernel_bf16_gpu`` — a CUDA/Triton kernel against its plain version on
  the card in bf16: one bf16 rounding of an O(1) output (2^-8) plus the
  order of the f32 sums.
* ``BF16_ULPS`` — bf16 RMSNorm, where XLA on the CPU may fuse the two bf16
  multiplies: at most one bf16 ulp apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

TOL = {
    "kernel_f32": dict(atol=1e-5, rtol=0.0),
    "norm_f32": dict(atol=1e-6, rtol=0.0),
    "model_f32": dict(atol=1e-4, rtol=1e-4),
    "kernel_bf16_gpu": dict(atol=2e-2, rtol=2e-2),
}
BF16_ULPS = 1


def np32(x) -> np.ndarray:
    """Any array-like (JAX array, torch tensor, numpy) as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def assert_close(got, want, kind: str) -> None:
    np.testing.assert_allclose(np32(got), np32(want), **TOL[kind])


def bf16_ulps(a, b) -> int:
    """Largest distance in bf16 ulps between two bf16 arrays (JAX or torch)."""

    def line(x):
        t = torch.from_numpy(np32(x)).to(torch.bfloat16)
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return int((line(a) - line(b)).abs().max().item())


def to_torch(x, dtype=None):
    """Numpy/JAX array -> CPU tensor (via f32 for bf16, which numpy lacks)."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(arr))
    return t if dtype is None else t.to(dtype)


def packed_scenario(page_size=16, kvh=2, h=4, d=16, seed=0, lens=(20, 9, 16)):
    """Mixed-phase packed queries over one pool with interleaved page
    ownership: slot 0 decodes, slot 1 verifies a 4-token tail, slot 2
    prefills every position (``test_kernels.py`` ``packed_scenario``)."""
    rng = np.random.default_rng(seed)
    num_slots = len(lens)
    nb = max(-(-n // page_size) for n in lens)
    num_pages = num_slots * nb
    tables = np.full((num_slots, nb), num_pages, np.int32)
    for s, n in enumerate(lens):
        for j in range(-(-n // page_size)):
            tables[s, j] = s + j * num_slots
    spans = [range(lens[0] - 1, lens[0]), range(max(lens[1] - 4, 0), lens[1]),
             range(lens[2])]
    q_pos = np.asarray([p for sp in spans for p in sp], np.int32)
    q_slots = np.asarray([s for s, sp in enumerate(spans) for _ in sp], np.int32)
    return dict(
        q=rng.normal(size=(len(q_pos), h, d)).astype(np.float32),
        k_pool=rng.normal(size=(num_pages, page_size, kvh, d)).astype(np.float32),
        v_pool=rng.normal(size=(num_pages, page_size, kvh, d)).astype(np.float32),
        tables=tables, q_pos=q_pos, q_slots=q_slots,
    )


def quantize_pool(pool):
    """Per-(token-row, kv-head) symmetric int8, the model's scheme."""
    amax = np.abs(pool).max(axis=-1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    codes = np.clip(np.round(pool / scale[..., None]), -127, 127).astype(np.int8)
    return codes, scale


class TestHelpers:
    def test_bf16_ulps_counts_adjacent_values(self):
        a = torch.tensor([1.0, -2.0, 0.0], dtype=torch.bfloat16)
        b = a.view(torch.int16).clone()
        b[0] += 1  # next bf16 above 1.0
        assert bf16_ulps(a, b.view(torch.bfloat16)) == 1
        assert bf16_ulps(a, a) == 0

    def test_bf16_ulps_across_zero(self):
        a = torch.tensor([0.0], dtype=torch.bfloat16)
        tiny = torch.tensor([1], dtype=torch.int16).view(torch.bfloat16)
        assert bf16_ulps(a, tiny) == 1
        assert bf16_ulps(-tiny, tiny) == 2

    def test_to_torch_bf16_roundtrip(self):
        jnp = pytest.importorskip("jax.numpy")
        x = jnp.asarray([1.5, -3.25], jnp.bfloat16)
        t = to_torch(x)
        assert t.dtype == torch.bfloat16
        assert t.float().tolist() == [1.5, -3.25]
