"""The port's Mamba-2 training path below the model, against the JAX package
on the CPU in f32.

Same numpy inputs through both packages:

* K6's plain backward ``ref.ssd_chunk_bwd_ref`` (dx, ddt, dcum, dB, dC in
  closed form) against ``jax.vjp`` of the reference's
  ``repro.kernels.ref.ssd_chunk_ref`` and against ``torch.autograd`` of the
  port's plain forward, at several (B, NC, L, H), L 16 and 64 among them,
  and at the built widths with the chunk lengths and head counts the card
  tests give the CUDA backward (under its metrics, ``SSD_BWD_TOL``), and
  with a dt = 0 padded tail as ``models.ssm._ssd_dense`` makes it;
  ``ops.ssd_chunk`` under autograd (``SsdChunkFn``) returns exactly the
  plain backward on the CPU;
* ``models.ssm._ssd_chunked`` under autograd (y and the final state both in
  the loss, with and without a carried state) against ``jax.grad`` of the
  reference's ``_ssd_chunked``, and one cache-free Mamba-2 block
  (``apply_ssd``) against ``jax.grad`` of the reference's, every parameter;
* ``_softplus``'s gradient against ``jax.nn.softplus``'s, its value
  bit-identical to the serving path's form;
* what the CUDA wrapper does before any launch: CPU tensors and unbuilt
  shapes refused, the scratch it allocates.

Tolerances are ``TOL["ssd_f32"]`` for the SSD term's gradients (sums over
the chunk in another order, outputs of O(10-100)) and ``TOL["model_f32"]``
for the whole scan and the block (as ``test_torch_ssm.py`` holds the scan's
forward: decays, the inter-chunk recurrence and the term compose, and dt's
gradient sums every path through cum).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref, ssd_chunk  # noqa: E402
from repro_torch.kernels.flash_attention import UnbuiltShapeError  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from test_torch_parity_util import (  # noqa: E402
    SSD_BWD_TOL,
    assert_close,
    norm_rel_err,
    row_rel_err,
    ssd_chunk_inputs,
)

torch.set_num_threads(1)

NAMES = ("dx", "ddt", "dcum", "db", "dc")
# (B, NC, L, H, P, N)
SHAPES = [(1, 2, 16, 3, 8, 5), (2, 1, 64, 2, 4, 6), (1, 3, 16, 4, 16, 8), (2, 2, 32, 1, 8, 16)]
#: at the built widths (head dim 64, state 128), the chunk lengths and head
#: counts at which the card's tests hold the CUDA backward against this
#: plain one: L 48 and 240 (3 and 15 row tiles, not a multiple of its 4
#: warps) with 3 and 5 heads, the 256-row training chunk, L 64 and 16
BUILT_SHAPES = [(2, 2, 48, 3, 64, 128), (1, 2, 240, 5, 64, 128), (1, 1, 256, 3, 64, 128),
                (1, 2, 64, 1, 64, 128), (1, 1, 16, 4, 64, 128)]


def _inputs(shape, seed, pad=0):
    """K6's inputs and a cotangent; the last ``pad`` rows of each chunk are
    padding as ``_ssd_dense`` makes it (dt, x, B and C zero)."""
    x, dt, cum, b, c = ssd_chunk_inputs(*shape, seed=seed)
    dy = np.random.default_rng(seed + 100).normal(size=x.shape).astype(np.float32)
    if pad:
        for t in (x, dt, b, c):
            t[:, :, -pad:] = 0
        cum[:, :, -pad:] = cum[:, :, -pad - 1: -pad]  # dt = 0: the decay stops
    return (x, dt, cum, b, c), dy


def _jax_vjp(args, dy):
    _, vjp = jax.vjp(jref.ssd_chunk_ref, *map(jnp.asarray, args))
    return vjp(jnp.asarray(dy))


class TestSsdChunkBackward:
    @pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
    def test_plain_backward_matches_jax(self, shape):
        args, dy = _inputs(shape, seed=sum(shape))
        got = ref.ssd_chunk_bwd_ref(*(torch.from_numpy(v) for v in args), torch.from_numpy(dy))
        for name, g, w in zip(NAMES, got, _jax_vjp(args, dy)):
            assert g.shape == w.shape, name
            assert_close(g, w, "ssd_f32")

    def test_padded_tail_matches_jax(self):
        """A chunk whose last rows are dt = 0 padding: their x, dt, B, C take
        zero forward weight but still get gradients."""
        args, dy = _inputs((2, 2, 32, 3, 8, 6), seed=5, pad=11)
        got = ref.ssd_chunk_bwd_ref(*(torch.from_numpy(v) for v in args), torch.from_numpy(dy))
        for g, w in zip(got, _jax_vjp(args, dy)):
            assert_close(g, w, "ssd_f32")

    @pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "x".join(map(str, s)))
    def test_plain_backward_matches_autograd(self, shape):
        args, dy = _inputs(shape, seed=7)
        leaves = [torch.from_numpy(v).requires_grad_() for v in args]
        ref.ssd_chunk_ref(*leaves).backward(torch.from_numpy(dy))
        got = ref.ssd_chunk_bwd_ref(*(torch.from_numpy(v) for v in args), torch.from_numpy(dy))
        for g, leaf in zip(got, leaves):
            assert_close(g, leaf.grad, "ssd_f32")

    @pytest.mark.parametrize("against", ["jax", "autograd"])
    @pytest.mark.parametrize("shape", BUILT_SHAPES, ids=lambda s: "x".join(map(str, s)))
    def test_plain_backward_at_the_built_widths(self, shape, against):
        """At head dim 64 and state 128 the sums over them cancel, and the
        elements no longer agree to ``ssd_f32``; the plain backward is held
        to the card's contract instead (``SSD_BWD_TOL``, dx row by row, the
        rest by norm), against ``jax.vjp`` of the reference and against
        autograd of the plain forward."""
        args, dy = _inputs(shape, seed=sum(shape))
        t = [torch.from_numpy(v) for v in args]
        got = ref.ssd_chunk_bwd_ref(*t, torch.from_numpy(dy))
        if against == "jax":
            want = _jax_vjp(args, dy)
        else:
            leaves = [v.clone().requires_grad_() for v in t]
            ref.ssd_chunk_ref(*leaves).backward(torch.from_numpy(dy))
            want = [leaf.grad for leaf in leaves]
        for g, w in zip(got, want):
            assert g.shape == w.shape
        errs = [row_rel_err(got[0], want[0])] + [norm_rel_err(g, w)
                                                 for g, w in zip(got[1:], want[1:])]
        assert max(errs) <= SSD_BWD_TOL, dict(zip(NAMES, errs))

    def test_ops_ssd_chunk_differentiates_through_the_plain_backward(self):
        """On the CPU ``SsdChunkFn`` runs the plain forward and backward:
        exactly what they return, and no kernel launch counted."""
        args, dy = _inputs(SHAPES[0], seed=3)
        before = ops.launch_counts()
        leaves = [torch.from_numpy(v).requires_grad_() for v in args]
        y = ops.ssd_chunk(*leaves)
        assert torch.equal(y, ref.ssd_chunk_ref(*(torch.from_numpy(v) for v in args)))
        y.backward(torch.from_numpy(dy))
        want = ref.ssd_chunk_bwd_ref(*(torch.from_numpy(v) for v in args), torch.from_numpy(dy))
        for name, leaf, w in zip(NAMES, leaves, want):
            assert torch.equal(leaf.grad, w), name
        assert ops.launch_counts() == before
        assert "ssd_chunk_bwd" in before

    def test_planted_faults_move_the_gradients(self):
        """What the card's checks plant: the diagonal key tile left out (of
        every output, dB among them) and dcum's row part dropped; both move
        their outputs far outside ``ssd_f32``."""
        args, dy = _inputs((1, 2, 32, 3, 8, 6), seed=11)
        t = [torch.from_numpy(v) for v in args]
        want = ref.ssd_chunk_bwd_ref(*t, torch.from_numpy(dy))
        rows = torch.arange(32)
        skip = (rows[:, None] >= rows[None]) & (rows[:, None] // 16 != rows[None] // 16)
        bad = ref.ssd_chunk_bwd_ref(*t, torch.from_numpy(dy), mask=skip)
        assert not torch.allclose(bad[3], want[3], **{"atol": 1e-2, "rtol": 1e-2})
        y = ref.ssd_chunk_ref(*t)
        no_row = want[2] + (torch.from_numpy(dy) * y).sum(-1)
        assert not torch.allclose(no_row, want[2], **{"atol": 1e-2, "rtol": 1e-2})
        # the kernel's identity: dcum = dt (x . u) - dy . y, u = dx / dt
        dx, ddt, dcum = want[:3]
        assert_close((t[1] * ddt) - (torch.from_numpy(dy) * y).sum(-1), dcum, "ssd_f32")
        assert_close((t[0] * dx).sum(-1), t[1] * ddt, "ssd_f32")


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("nc", [1, 3])
def test_chunked_scan_gradients_match_jax(carried, nc):
    """``_ssd_chunked``'s gradients for x, dt, a, B, C (and the carried
    state): the intra-chunk term through ``SsdChunkFn``, the inter-chunk
    loop and decays through autograd; the loss reads y and the final state."""
    rng = np.random.default_rng(nc + 2 * carried)
    bs, chunk, h, p, n = 2, 16, 3, 8, 5
    s = nc * chunk
    x = rng.normal(size=(bs, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.1, 0.9, size=(bs, s, h)).astype(np.float32)
    a = np.linspace(1.0, 4.0, h, dtype=np.float32)
    b = rng.normal(size=(bs, s, n)).astype(np.float32)
    c = rng.normal(size=(bs, s, n)).astype(np.float32)
    init = rng.normal(size=(bs, h, n, p)).astype(np.float32) if carried else None
    wy = rng.normal(size=(bs, s, h, p)).astype(np.float32)
    wf = rng.normal(size=(bs, h, n, p)).astype(np.float32)
    inputs = [x, dt, a, b, c] + ([init] if carried else [])

    def jloss(*v):
        y, final = jssm._ssd_chunked(*v[:5], chunk, init_state=v[5] if carried else None)
        return jnp.sum(y * wy) + jnp.sum(final * wf)

    want = jax.grad(jloss, argnums=tuple(range(len(inputs))))(*map(jnp.asarray, inputs))
    leaves = [torch.from_numpy(v).requires_grad_() for v in inputs]
    y, final = ssm._ssd_chunked(*leaves[:5], chunk, init_state=leaves[5] if carried else None)
    ((y * torch.from_numpy(wy)).sum() + (final * torch.from_numpy(wf)).sum()).backward()
    for leaf, w in zip(leaves, want):
        assert_close(leaf.grad, w, "model_f32")


@pytest.mark.parametrize("seq", [32, 24], ids=["two_chunks", "padded"])
def test_cache_free_block_gradients_match_jax(seq):
    """One Mamba-2 block of the smoke config without a cache, as training
    runs it: the gradient of every parameter and of the input."""
    jc, tc = jget_smoke("mamba2_130m"), get_smoke_config("mamba2_130m")
    params = jssm.init_ssd(jax.random.PRNGKey(4), jc)
    rng = np.random.default_rng(seq)
    # spread dt_bias so that softplus sees both signs and the decays differ
    params = dict(params, dt_bias=jnp.asarray(rng.normal(size=params["dt_bias"].shape),
                                              jnp.float32))
    x = rng.normal(size=(2, seq, jc.d_model)).astype(np.float32)
    w = rng.normal(size=(2, seq, jc.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jssm.apply_ssd(p, xx, jc)[0] * w)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (ssm.apply_ssd(tp, tx, tc)[0] * torch.from_numpy(w)).sum().backward()
    for k, v in tp.items():
        assert_close(v.grad, jg[k], "model_f32")
    assert_close(tx.grad, jgx, "model_f32")


def test_softplus_gradient_is_jax_softplus():
    """sigmoid(x), 1/2 at 0 (autograd of the serving form gives 1 there);
    the value bit-identical to max(x, 0) + log1p(exp(-|x|))."""
    xs = np.array([0.0, 1e-3, -1e-3, 30.0, -30.0, 2.5, -7.0], np.float32)
    x = torch.from_numpy(xs).requires_grad_()
    y = ssm._softplus(x)
    y.sum().backward()
    want = jax.vmap(jax.grad(jax.nn.softplus))(jnp.asarray(xs))
    assert float(x.grad[0]) == 0.5
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    form = x.detach().clamp(min=0) + torch.log1p(torch.exp(-x.detach().abs()))
    assert torch.equal(y.detach(), form)
    assert_close(y, jax.nn.softplus(jnp.asarray(xs)), "kernel_f32")


class TestWrapperBeforeLaunch:
    def test_refuses_cpu_tensors_and_unbuilt_shapes(self):
        args, dy = _inputs((1, 1, 64, 2, 64, 128), seed=0)
        t = [torch.from_numpy(v) for v in args]
        y, g = torch.zeros_like(t[0]), torch.from_numpy(dy)
        with pytest.raises(ValueError, match="CUDA"):
            ssd_chunk.ssd_chunk_bwd(*t, y, g)
        with pytest.raises(UnbuiltShapeError):
            ssd_chunk.require_built(16, 32)
        assert ssd_chunk.UnbuiltShapeError is UnbuiltShapeError

    def test_scratch_at_the_training_shape(self):
        """4 sequences of 2048 tokens in 256-token chunks: one (32, 256, 256)
        f32 scratch of dS summed over every head, 8.4 MB whatever the heads
        (the backward's two passes hand dS over through it)."""
        assert ssd_chunk.scratch_bytes(32, 256) == 32 * 256 * 256 * 4 == 8_388_608
        assert ssd_chunk.scratch_bytes(1, 48) == 48 * 48 * 4

    def test_chunk_lengths_the_backward_takes(self):
        """``require_trainable``'s rule on the scan's chunk at a sequence
        length (``ssm.chunk_len``): multiples of 16 up to 256."""
        cfg = dataclasses.replace(get_smoke_config("mamba2_130m"), ssm_state=128,
                                  ssm_head_dim=64, ssm_chunk=256)
        assert ssm.chunk_len(2048, cfg.ssm_chunk) == 256
        assert ssm.chunk_len(40, cfg.ssm_chunk) == 48
        assert ssm.chunk_len(40, cfg.ssm_chunk) % ssd_chunk.ROW_TILE == 0
        assert ssd_chunk.BWD_MAX_LEN == 256
