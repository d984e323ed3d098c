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
  f32, by ``row_rel_err``: C . B^T in the plain version's order, att . x in
  3xTF32 and CUDA's expf (2 ulp) against torch's exp, ~3e-7 a row; a
  planted fault (the diagonal key tile skipped, or the segment mask
  dropped) reads above 0.1.
* ``SSD_BWD_TOL`` — K6's backward against its plain version on the card,
  both f32: dx row by row (``row_rel_err``; u in 3xTF32 like the forward's
  att . x), ddt, dcum, dB and dC each by ``norm_rel_err`` (dot products
  over the head dim, dcum the difference of two of them, dB / dC sums over
  the heads and the chunk in another order: ~1e-6); a planted fault (the
  diagonal key tile left out, or dcum's row part dropped) reads above 0.01.
* ``BF16_ULPS`` — bf16 RMSNorm, where XLA on the CPU may fuse the two bf16
  multiplies: at most one bf16 ulp apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention, ref  # noqa: E402

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
SSD_BWD_TOL = 1e-4


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


def ulp_line(x: torch.Tensor) -> torch.Tensor:
    """A bf16 or f16 tensor's values as integers one ulp apart (both formats
    order their bit patterns by sign and magnitude)."""
    i = x.detach().contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def ulps16(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in ulps between two torch tensors of one 16-bit
    float dtype, bf16 or f16."""
    return int((ulp_line(a) - ulp_line(b)).abs().max().item())


#: K2 in model mode, bf16 or f16: a row whose inv (in f64) lies within this
#: of the midpoint between two neighbouring values of x's dtype (relative)
#: may have inv rounded either way by a kernel and by the plain version, each
#: with its own f32 sum of squares and rsqrt (~1e-6 apart at most)
K2_INV_TIE = 2.0 ** -18


def rmsnorm_model_ulps(out, x, s, eps=1e-6):
    """(ulps, tie rows): the largest distance in ulps of ``out`` (bf16 or
    f16) from ``ref.rmsnorm_model``, row by row; a row whose inv is a tie
    (``K2_INV_TIE``) is also measured against the output with inv rounded
    the other way, and the nearer of the two counts.  Every other row is
    held to the plain version alone."""
    def row_ulps(a, b):
        return (ulp_line(a) - ulp_line(b)).abs().amax(-1)

    plain_inv = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + eps).to(x.dtype)
    inv = torch.rsqrt(x.double().square().mean(-1, keepdim=True) + eps)
    # inv > 0: its neighbours in x's dtype are the bit patterns one apart
    bits = plain_inv.view(torch.int16)
    up, down = (bits + 1).view(x.dtype), (bits - 1).view(x.dtype)
    other = torch.where(plain_inv.double() <= inv, up, down)
    tie = ((inv - (plain_inv.double() + other.double()) / 2).abs() <= K2_INV_TIE * inv)[..., 0]
    u = row_ulps(out, ref.rmsnorm_model(x, s, eps))
    u_other = row_ulps(out, x * other * s.to(x.dtype))
    return int(torch.where(tie, torch.minimum(u, u_other), u).max()), int(tie.sum())


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


def norm_rel_err(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor."""
    got = torch.from_numpy(np32(got))
    want = torch.from_numpy(np32(want))
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp(min=1e-30))


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


def plan_scenario(name, page_size=4):
    """Small steps in the shapes of chip_smoke.py's K4 cases (qwen's group of
    8 heads over 2 KV heads, head dim 16): ``mixed`` has decode tokens,
    prefill chunks longer than a tile and a verify-sized span; the others
    change it as their names say."""
    if name == "decode":
        a = packed_scenario(page_size=page_size, kvh=2, h=16, d=16, seed=31,
                            lens=(45, 12, 30, 7))
        last = [int(np.flatnonzero(a["q_slots"] == s).max()) for s in range(3)]
        keep = np.r_[last, 0]
        a = dict(a, q=a["q"][keep], q_pos=a["q_pos"][keep], q_slots=a["q_slots"][keep])
        a["q_slots"][-1] = -1  # a padding query
        return a
    a = packed_scenario(page_size=page_size, kvh=2, h=16, d=16, seed=37, lens=(41, 23, 37))
    if name == "hostile_tables":
        a["tables"][0, 0] = -3
        a["tables"][2, 1] = a["k_pool"].shape[0] + 5
    elif name == "padding":
        a["q_slots"][::6] = -1
    elif name == "fully_masked":
        a["tables"][2, :] = -1
    elif name == "interleaved":  # the slots' tokens shuffled together
        order = np.random.default_rng(5).permutation(len(a["q_pos"]))
        a = dict(a, q=a["q"][order], q_pos=a["q_pos"][order], q_slots=a["q_slots"][order])
    return a


def walk_plan(a, window=0, softcap=0.0, sms=132, rows=None):
    """A numpy walk of the paged kernel's schedule, f32: each (tile, KV
    head, split) of ``paged_tile_plan`` / ``split_blocks`` walks its slice
    in stages of 64 key positions and chunks of 16, the chunks dealt to the
    warps of each token pair as ``paged_attention.cu`` deals them, each
    warp with its own online softmax per (token, head); the warps merge,
    then the splits (``paged_attention_combine``).  ``rows`` pads the plan
    (a serving step's fixed row count): its empty tiles walk nothing.
    Returns (output, plan)."""
    q = np32(a["q"])
    kp_, vp_ = np32(a["k_pool"]), np32(a["v_pool"])
    if "k_scale" in a:
        kp_, vp_ = kp_ * a["k_scale"][..., None], vp_ * a["v_scale"][..., None]
    tables, q_pos, q_slots = (np.asarray(a[k]) for k in ("tables", "q_pos", "q_slots"))
    t, h, d = q.shape
    num_pages, ps, kvh, _ = kp_.shape
    g, nb = h // kvh, tables.shape[1]
    plan = flash_attention.paged_tile_plan(q_pos, q_slots, ps, nb, window, rows)
    splits, per = flash_attention.split_blocks(len(plan) * kvh, nb, sms)
    parts = np.zeros((t, kvh, splits, g, d + 2), np.float64)
    for t0, n, slot, b_lo, b_hi in plan:
        pairs = -(-n // 2)
        ks_n = 1  # warps a token pair's chunks are dealt to (kWarps = TILE_TOKENS / 2)
        while 2 * ks_n * pairs <= flash_attention.TILE_TOKENS // 2 and 2 * ks_n <= 4:
            ks_n *= 2
        for kv in range(kvh):
            for sp in range(splits):
                b0 = b_lo + sp * per
                b1 = min(b_hi, nb, b0 + per)
                if slot < 0 or b0 >= b1:
                    b0 = b1 = 0
                # per (warp, token): m, l (g,), acc (g, d)
                st = {}
                for p0 in range(b0 * ps, b1 * ps, 64):
                    for c in range(4):
                        keys = np.arange(p0 + 16 * c, p0 + 16 * c + 16)
                        blk = np.minimum(keys // ps, nb - 1)
                        page = tables[slot, blk]
                        ok = (keys < b1 * ps) & (page >= 0) & (page < num_pages)
                        rows = np.where(ok, page, 0), keys % ps
                        kk, vv = kp_[rows[0], rows[1], kv], vp_[rows[0], rows[1], kv]
                        for tok in range(n):
                            w = (tok // 2) * ks_n + c % ks_n
                            pos = q_pos[t0 + tok]
                            s = q[t0 + tok, kv * g:(kv + 1) * g] @ kk.T / np.sqrt(d)
                            if softcap > 0:
                                s = softcap * np.tanh(s / softcap)
                            inn = ok & (keys <= pos)
                            if window > 0:
                                inn &= keys > pos - window
                            m, l, acc = st.get((w, tok), (np.full(g, -1e30), np.zeros(g),
                                                          np.zeros((g, d))))
                            m_new = np.maximum(m, np.where(inn, s, -1e30).max(axis=1))
                            p = np.exp(np.where(inn, s - m_new[:, None], -np.inf))
                            alpha = np.exp(m - m_new)
                            st[w, tok] = (m_new, l * alpha + p.sum(1), acc * alpha[:, None] + p @ vv)
                for tok in range(n):
                    ws = [st[k] for k in st if k[1] == tok] or [
                        (np.full(g, -1e30), np.zeros(g), np.zeros((g, d)))]
                    mx = np.max([m for m, _, _ in ws], axis=0)
                    cw = [np.exp(m - mx) for m, _, _ in ws]
                    parts[t0 + tok, kv, sp, :, 0] = mx
                    parts[t0 + tok, kv, sp, :, 1] = sum(l * c for (_, l, _), c in zip(ws, cw))
                    parts[t0 + tok, kv, sp, :, 2:] = sum(x * c[:, None] for (_, _, x), c in zip(ws, cw))
    mx = parts[..., 0].max(axis=2, keepdims=True)
    cw = np.exp(parts[..., 0] - mx)
    total = (parts[..., 1] * cw).sum(2)
    acc = (parts[..., 2:] * cw[..., None]).sum(2)
    return (acc / np.maximum(total, 1e-30)[..., None]).reshape(t, h, d).astype(np.float32), plan


def dscale_without_rows(x, s, dy, rows, eps=1e-6, model=False):
    """A planted K2-backward fault: dscale with ``rows`` (a slice, e.g. one
    CTA's) left out of the column sums, by the plain version."""
    keep = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    keep[rows] = False
    return ref.rmsnorm_bwd_ref(x[keep], s, dy[keep], eps, model)[1]


def rmsnorm_without_last_vector(x, s, eps=1e-6, model=False):
    """A planted K2-forward fault: what a kernel that leaves each row's last
    16-byte vector out of its sum of squares (the mean still over d) would
    return, by the plain version's numerics."""
    d = x.shape[-1]
    ms = x[..., :d - 16 // x.element_size()].float().square().sum(-1, keepdim=True) / d
    inv = torch.rsqrt(ms + eps)
    if model:
        return x * inv.to(x.dtype) * s.to(x.dtype)
    return (x.float() * inv * s.float()).to(x.dtype)


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
