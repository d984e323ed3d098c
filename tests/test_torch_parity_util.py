"""Shared parity helpers for the PyTorch port's tests: the one tolerance
table every ``test_torch_*`` file uses, the numpy bridges between the two
packages, and the seeded paged-attention scenarios the CPU and the card
tests share.  It imports no JAX, so the card's tests can use it.

Tolerances (``TOL``), each with its reason:

* ``kernel_f32`` — a plain kernel version against the JAX reference on the
  CPU in f32: the same math in another summation order, ~1e-6 apart.
* ``norm_f32`` — RMSNorm in f32 on the CPU: a mean and an rsqrt, ~1e-7.
* ``ssd_f32`` — an SSD term (K5 / K6 plain versions) against the JAX
  reference on the CPU in f32: up to L products of C . B (O(sqrt N)),
  a decay and x summed in another order; outputs reach O(10-100), so the
  gap scales with them (~1e-7 relative).
* ``model_f32`` — prefill logits and cache rows of a small f32 model:
  a few layers of matmuls in another order; logits of O(1-10).
* ``kernel_bf16_gpu`` — a CUDA/Triton kernel against its plain version on
  the card in bf16: one bf16 rounding of an O(1) output (2^-8) plus the
  order of the f32 sums.
* ``K3_ROW_TOL`` — K3 against its plain version on the card in bf16, by
  ``row_rel_err``: each row's own roundings (P and dS to bf16 before the
  products, each output once, 2^-9 relative each) stay near 1e-3; a
  planted fault (``skip_diagonal_tile_mask``) reads above 0.1.
* ``SSD_ROW_TOL`` — K5 / K6 against their plain versions on the card, both
  f32, by ``row_rel_err``: the same sums in another order and CUDA's expf
  (2 ulp) against torch's exp, ~1e-6 a row; a planted fault (the diagonal
  key tile skipped, or the segment mask dropped) reads above 0.1.
* ``BF16_ULPS`` — bf16 RMSNorm, where XLA on the CPU may fuse the two bf16
  multiplies: at most one bf16 ulp apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

TOL = {
    "kernel_f32": dict(atol=1e-5, rtol=0.0),
    "norm_f32": dict(atol=1e-6, rtol=0.0),
    "ssd_f32": dict(atol=1e-5, rtol=1e-5),
    "model_f32": dict(atol=1e-4, rtol=1e-4),
    "kernel_bf16_gpu": dict(atol=2e-2, rtol=2e-2),
}
BF16_ULPS = 1
K3_ROW_TOL = 2e-2
SSD_ROW_TOL = 1e-4


def np32(x) -> np.ndarray:
    """Any array-like (JAX array, torch tensor, numpy) as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def assert_close(got, want, kind: str) -> None:
    np.testing.assert_allclose(np32(got), np32(want), **TOL[kind])


def tree_np(tree):
    """A port tree (dict / tuple / list of tensors) with numpy f32 leaves."""
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_np(v) for v in tree)
    return np32(tree)


def assert_tree_close(got, want, kind: str) -> None:
    """Every leaf of a port tree against the same path of a JAX tree (the
    two share path names, so ``jax.tree.map`` pairs them by path)."""
    import jax

    jax.tree.map(lambda w, g: assert_close(g, w, kind), want, tree_np(got))


def bf16_ulps(a, b) -> int:
    """Largest distance in bf16 ulps between two bf16 arrays (JAX or torch)."""

    def line(x):
        t = torch.from_numpy(np32(x)).to(torch.bfloat16)
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return int((line(a) - line(b)).abs().max().item())


def row_rel_err(got, want) -> float:
    """max over rows (the last axis) of ||got_r - want_r|| / ||want_r||, a
    row's norm taken as at least 2^-12 of the largest row's: a row that is
    zero in exact arithmetic (dq of a query with one admissible key) is f32
    rounding noise in both versions, ~1e-6 against rows of ~10.  Held per
    row, a causal attention output (whose row norm falls as 1/sqrt(the
    row's key count)) cannot hide a wrong late row under an early one."""
    got = torch.from_numpy(np32(got))
    want = torch.from_numpy(np32(want))
    num = torch.linalg.vector_norm(got - want, dim=-1)
    den = torch.linalg.vector_norm(want, dim=-1)
    return float((num / den.clamp(min=2.0 ** -12 * float(den.max()) + 1e-30)).max())


def skip_diagonal_tile_mask(s: int, device=None, tile: int = 64):
    """Causal (1, S, S) admissible pairs less each query row's own 64-key
    tile for the rows from S/2 on: a planted K3 fault (a kernel that skips
    its diagonal tile late in the sequence)."""
    from repro_torch.kernels import ref

    rows = torch.arange(s, device=device)[:, None]
    keys = torch.arange(s, device=device)[None]
    skipped = (rows >= s // 2) & (keys // tile == rows // tile)
    return ref.attention_mask(s, s, True, 0, device=device) & ~skipped


def ssd_chunk_inputs(bs, nc, l, h, p, n, seed):
    """``tests/test_ssd_kernel.py``'s inputs, drawn with numpy: x, dt in
    [0.1, 0.9], cum a running sum of steps in [0.01, 0.2] within each
    chunk, B and C."""
    rng = np.random.default_rng(seed)
    steps = rng.uniform(0.01, 0.2, size=(bs, nc, l, h)).astype(np.float32)
    return (rng.normal(size=(bs, nc, l, h, p)).astype(np.float32),
            rng.uniform(0.1, 0.9, size=(bs, nc, l, h)).astype(np.float32),
            np.cumsum(steps, axis=2, dtype=np.float32),
            rng.normal(size=(bs, nc, l, n)).astype(np.float32),
            rng.normal(size=(bs, nc, l, n)).astype(np.float32))


def ssd_skip_diagonal_tile_mask(l: int, device=None, tile: int = 64):
    """Causal (L, L) admissible pairs less each row's own ``tile``-key tile:
    a planted K6 fault (a kernel that skips its diagonal key tile)."""
    rows = torch.arange(l, device=device)
    tri = rows[:, None] >= rows[None]
    return tri & ~(rows[:, None] // tile == rows[None] // tile)


def ssd_segment_inputs(seg, h, p, n, seed, a_max=2.0):
    """A packed step's SSD inputs over segments ``seg`` (< 0 padding, dt 0
    there), ``cum`` one running sum of dt * a over the whole packed axis as
    the model forms it (a up to ``a_max``)."""
    rng = np.random.default_rng(seed)
    seg = np.asarray(seg, np.int32)
    t = len(seg)
    dt = rng.uniform(0.1, 0.9, size=(t, h)).astype(np.float32)
    dt[seg < 0] = 0.0
    a = np.linspace(1.0, a_max, h, dtype=np.float32)
    return (rng.normal(size=(t, h, p)).astype(np.float32), dt,
            np.cumsum(dt * a, axis=0, dtype=np.float32),
            rng.normal(size=(t, n)).astype(np.float32),
            rng.normal(size=(t, n)).astype(np.float32), seg)


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


def skip_last_page(a, plan_row):
    """A planted K4 fault: inputs (numpy arrays or tensors) on which the
    plain version returns what a kernel that skips the last page of tile
    ``plan_row`` (first token, tokens, slot, block lo, block hi) would
    return.  The tile's tokens move to a new slot whose table is their
    slot's with that block's entry made hostile (masked); every other
    token sees its slot unchanged."""
    t0, n, slot, _, hi = (int(x) for x in plan_row)
    tables, slots = a["tables"], a["q_slots"]
    if isinstance(tables, torch.Tensor):
        tables, slots = torch.cat([tables, tables[slot:slot + 1]]), slots.clone()
    else:
        tables, slots = np.concatenate([tables, tables[slot:slot + 1]]), slots.copy()
    tables[-1, hi - 1] = -1
    slots[t0:t0 + n] = len(tables) - 1
    return dict(a, tables=tables, q_slots=slots)


def dscale_without_rows(x, s, dy, rows, eps=1e-6, model=False):
    """A planted K2-backward fault: dscale with ``rows`` (a slice, e.g. one
    CTA's) left out of the column sums, by the plain version."""
    keep = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    keep[rows] = False
    return ref.rmsnorm_bwd_ref(x[keep], s, dy[keep], eps, model)[1]


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
