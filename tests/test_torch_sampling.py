"""The port's stochastic sampler against the JAX package's, on the CPU.

* JAX's PRNG in plain torch: the words of ``fold_in(PRNGKey(s), i)`` and
  ``jax.random.bits`` for seeds 0, 1 and 2^32 - 1 and output indices 0 up
  to 2^31 - 1, exactly; the uniforms exactly; each of the Gumbel draw's two
  ``log`` calls within ``LOG_ULPS`` of XLA's on the same input, and the
  draw as a whole within ``GUMBEL_TOL`` (an ulp of the inner log near 1,
  ~2^-24, divided by -log(u) ~ 1, carried into the outer log: measured
  2^-21 at most); ``categorical`` (``residual_sample``'s draw) exactly;
* ``sample_tokens`` / ``sample_one`` / ``residual_sample`` on a matrix of
  temperature x top-k x top-p with mixed greedy rows: the same tokens;
* the top-k keep masks exactly (the counts are integers), the top-p masks
  exactly on these rows (``_keep_mask`` sums the probabilities in another
  order than XLA; the test prints how near each row's mass came to its
  threshold);
* the host-side program choice (``sample_mode``) and the parameter checks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serve import sampling as jsampling  # noqa: E402
from repro_torch.serve import sampling as S  # noqa: E402

torch.set_num_threads(1)

SEEDS = (0, 1, 2**32 - 1)
INDICES = (0, 1, 2, 1000, 2**20, 2**31 - 1)
#: one ulp of each log, the library's against XLA's
LOG_ULPS = 1
#: the Gumbel draw, port against JAX (see the module doc)
GUMBEL_TOL = dict(atol=2.0 ** -20, rtol=2.0 ** -21)


def jax_key(seed, i):
    return jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), np.uint32(i))


def port_key(seed, i):
    return S.fold_in(S.prng_key(torch.tensor([seed])), torch.tensor([i]))


def ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("index", INDICES)
def test_words_match_jax_random(seed, index):
    k = jax_key(seed, index)
    tk = port_key(seed, index)
    np.testing.assert_array_equal(tk.numpy()[0], np.asarray(k).astype(np.int64))
    want = np.asarray(jax.random.bits(k, (4099,), jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(S.random_bits(tk, 4099).numpy()[0], want)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_gumbel_match_jax_random(seed):
    tiny = np.finfo(np.float32).tiny
    for index in (0, 3, 2**20):
        k, tk = jax_key(seed, index), port_key(seed, index)
        bits = S.random_bits(tk, 20000)
        u = S.uniform_from_bits(bits, S._TINY).numpy()[0]
        want_u = np.asarray(jax.random.uniform(k, (20000,), jnp.float32, minval=tiny, maxval=1.0))
        np.testing.assert_array_equal(u.view(np.int32), want_u.view(np.int32))
        np.testing.assert_array_equal(
            S.uniform_from_bits(bits).numpy()[0].view(np.int32),
            np.asarray(jax.random.uniform(k, (20000,), jnp.float32)).view(np.int32))
        inner = np.asarray(jnp.log(want_u))
        assert ulps(torch.log(torch.from_numpy(want_u.copy())).numpy(), inner) <= LOG_ULPS
        assert ulps(torch.log(torch.from_numpy(-inner)).numpy(),
                    np.asarray(jnp.log(-inner))) <= LOG_ULPS
        g = S.gumbel_from_bits(bits).numpy()[0]
        np.testing.assert_allclose(g, np.asarray(jax.random.gumbel(k, (20000,), jnp.float32)),
                                   **GUMBEL_TOL)


def test_row_gumbel_matches_vmapped_rows():
    seeds = np.asarray([0, 7, 2**32 - 1, 12345], np.uint32)
    idx = np.asarray([0, 5, 2**20, 2**31 - 1], np.uint32)
    want = jax.vmap(jsampling._row_gumbel, in_axes=(0, 0, None))(seeds, idx, 333)
    got = S.row_gumbel(torch.from_numpy(seeds.astype(np.int64)),
                       torch.from_numpy(idx.astype(np.int64)), 333)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GUMBEL_TOL)


@pytest.mark.parametrize("shape", [(7,), (3, 50), (2, 3, 40)])
def test_categorical_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    for s in range(5):
        key = jax.random.PRNGKey(s)
        lg = rng.normal(size=shape).astype(np.float32) * 3
        want = np.asarray(jax.random.categorical(key, jnp.asarray(lg), axis=-1))
        got = S.categorical(torch.from_numpy(np.asarray(key).astype(np.int64)),
                            torch.from_numpy(lg))
        np.testing.assert_array_equal(got.numpy(), want)


def test_sort_key_is_jax_sort_key():
    """Normal floats only: XLA's CPU backend flushes a subnormal score to
    zero before encoding it (-1e-38 gets 0.0's key), torch does not (a
    subnormal logit is not a serving case)."""
    x = np.asarray([-np.inf, -3.5, -0.0, 0.0, 1e-30, 2.0, np.inf, -1e-30, 7.25], np.float32)
    want = np.asarray(jsampling._sort_key(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(S._sort_key(torch.from_numpy(x)).numpy(), want)
    assert (np.diff(want[np.argsort(x, kind="stable")]) >= 0).all()


def logits_rows(rows, v, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    lg = rng.normal(size=(rows, v)).astype(np.float32) * scale
    lg[0, :5] = lg[0, 0]  # a tie at the top of row 0
    return lg


@pytest.mark.parametrize("top_k", [0, 1, 3, 50])
def test_topk_keep_mask_exact(top_k):
    lg = logits_rows(6, 211, seed=top_k)
    t = np.asarray([0.7, 1.3, 1.0, 0.5, 2.0, 0.9], np.float32)
    scaled = lg / t[:, None]
    tk = np.full(6, top_k, np.int32)
    tk[1] = 0  # a row without the filter
    tp = np.ones(6, np.float32)
    want = np.asarray(jsampling._keep_mask(jnp.asarray(scaled), jnp.asarray(tk), jnp.asarray(tp),
                                           use_topk=True, use_topp=False))
    got = S._keep_mask(torch.from_numpy(scaled), torch.from_numpy(tk.astype(np.int64)),
                       torch.from_numpy(tp), True, False)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("top_p", [1e-6, 0.3, 0.9, 0.999])
def test_topp_keep_mask(top_p):
    lg = logits_rows(6, 211, seed=int(top_p * 1000) + 1)
    scaled = lg / 0.8
    tk = np.zeros(6, np.int32)
    tp = np.full(6, top_p, np.float32)
    want = np.asarray(jsampling._keep_mask(jnp.asarray(scaled), jnp.asarray(tk), jnp.asarray(tp),
                                           use_topk=False, use_topp=True))
    got = S._keep_mask(torch.from_numpy(scaled), torch.from_numpy(tk.astype(np.int64)),
                       torch.from_numpy(tp), False, True).numpy()
    # how near each row's kept mass came to top_p (f32 sums in another order)
    probs = np.exp(scaled - scaled.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    margin = np.abs((probs * want).sum(1) - top_p)
    print(f"top_p {top_p}: kept mass minus top_p, nearest row {margin.min():.3e}")
    np.testing.assert_array_equal(got, want)
    assert want.any(axis=1).all()  # the top token always survives


MATRIX = [(t, k, p) for t in (0.0, 0.7, 1.3) for k in (0, 1, 50) for p in (1.0, 0.9, 1e-6)]


@pytest.mark.parametrize("temperature,top_k,top_p", MATRIX)
def test_sample_tokens_match_reference(temperature, top_k, top_p):
    rows, v = 8, 503
    lg = logits_rows(rows, v, seed=int(temperature * 10 + top_k + top_p * 7))
    seeds = np.asarray([0, 1, 2**32 - 1, 7, 99, 2**31, 5, 123456789], np.uint32)
    oidx = np.asarray([0, 1, 2, 3, 2**20, 17, 2**31 - 1, 9], np.int32)
    temps = np.full(rows, temperature, np.float32)
    temps[3] = 0.0  # mixed greedy rows
    tk = np.full(rows, top_k, np.int32)
    tp = np.full(rows, top_p, np.float32)
    want = np.asarray(jsampling.sample_tokens(jnp.asarray(lg), seeds, oidx, temps, tk, tp))
    got = S.sample_tokens(torch.from_numpy(lg), seeds, oidx, temps, tk, tp)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[3] == lg[3].argmax())


def test_sample_tokens_leading_shape_and_bf16():
    rng = np.random.default_rng(3)
    lg = rng.normal(size=(2, 3, 64)).astype(np.float32)
    kw = [np.full((2, 3), x, d) for x, d in ((11, np.uint32), (4, np.int32), (0.9, np.float32),
                                                (5, np.int32), (0.8, np.float32))]
    want = np.asarray(jsampling.sample_tokens(jnp.asarray(lg), *kw))
    got = S.sample_tokens(torch.from_numpy(lg), *kw)
    assert got.shape == (2, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    bf = torch.from_numpy(lg).to(torch.bfloat16)
    want = np.asarray(jsampling.sample_tokens(jnp.asarray(bf.float().numpy(), jnp.bfloat16), *kw))
    np.testing.assert_array_equal(S.sample_tokens(bf, *kw).numpy(), want)


@pytest.mark.parametrize("params", [
    S.SamplingParams(), S.SamplingParams(temperature=0.8, seed=3),
    S.SamplingParams(temperature=1.1, top_k=5, seed=2**32 - 1),
    S.SamplingParams(temperature=0.6, top_p=0.5, seed=42),
    S.SamplingParams(temperature=1.0, top_k=20, top_p=0.95, seed=8)])
def test_sample_one_matches_reference(params):
    from repro.serve.sampling import SamplingParams as JParams

    jparams = JParams(params.temperature, params.top_k, params.top_p, params.seed)
    lg = logits_rows(1, 503, seed=params.seed % 1000)[0]
    for i in (0, 1, 31, 2**20):
        assert S.sample_one(torch.from_numpy(lg), params, i) == \
            jsampling.sample_one(jnp.asarray(lg), jparams, i)


@pytest.mark.parametrize("seed", [0, 1, 2**32 - 1])
def test_residual_sample_matches_reference(seed):
    rng = np.random.default_rng(seed % 97)
    tl = rng.normal(size=(4, 97)).astype(np.float32) * 2
    q = rng.dirichlet(np.ones(97), size=4).astype(np.float32)
    # row 3: q == p, each package's own softmax (the two differ by ulps), so
    # both residuals are zero and both sample p itself
    jq, tq = q.copy(), torch.from_numpy(q.copy())
    jq[3] = np.asarray(jax.nn.softmax(jnp.asarray(tl[3])))
    tq[3] = torch.softmax(torch.from_numpy(tl[3]), dim=-1)
    key = jax.random.PRNGKey(np.uint32(seed))
    want = np.asarray(jsampling.residual_sample(jnp.asarray(tl), jnp.asarray(jq), key))
    got = S.residual_sample(torch.from_numpy(tl), tq,
                            torch.from_numpy(np.asarray(key).astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_mode_follows_the_host_arrays():
    assert S.sample_mode([0.0, 0.0], [5, 0], [0.5, 1.0]) == "greedy"
    assert S.sample_mode([0.7, 0.0], [0, 5], [1.0, 0.5]) == "plain"
    assert S.sample_mode([0.7, 0.1], [0, 5], [1.0, 1.0]) == "topk"
    assert S.sample_mode([0.7, 0.1], [0, 0], [0.5, 1.0]) == "topp"
    assert S.sample_mode([0.7], [3], [0.5]) == "topk+topp"


def test_programs_give_one_token_per_row():
    """A row's token does not depend on the program that serves it: an
    untruncated row sampled under the top-k program, and a greedy row under
    any, give what the narrower program gives."""
    lg = torch.from_numpy(logits_rows(3, 257, seed=4))
    args = S.sampler_inputs([1, 2, 3], [0, 4, 9], [0.9, 0.0, 1.2], [0, 0, 0], [1.0, 1.0, 1.0])
    plain = S.sample_rows(lg, *args, "plain")
    for mode in ("topk", "topp", "topk+topp"):
        assert torch.equal(S.sample_rows(lg, *args, mode), plain)
    assert plain[1] == lg[1].argmax()


def test_params_validation():
    for bad in (dict(temperature=-1.0), dict(temperature=float("nan")), dict(top_k=-1),
                dict(top_p=0.0), dict(top_p=1.5), dict(seed=1.5)):
        with pytest.raises(ValueError):
            S.SamplingParams(**bad)
    assert S.GREEDY.greedy and not S.SamplingParams(temperature=0.1).greedy
    assert S.SamplingParams(seed=1).with_seed(9).seed == 9
