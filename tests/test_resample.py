"""Resampling kernel correctness."""
import jax
import jax.numpy as jnp
import numpy as np

from epitpu.smc import multinomial_resample, normalized_weights, systematic_resample


def test_normalized_weights_basic():
    logw = jnp.log(jnp.array([0.1, 0.2, 0.7]))
    w, lse, degen = normalized_weights(logw)
    np.testing.assert_allclose(w, [0.1, 0.2, 0.7], rtol=3e-4)
    assert not bool(degen)


def test_normalized_weights_degenerate():
    logw = jnp.full((4,), -jnp.inf)
    w, lse, degen = normalized_weights(logw)
    assert bool(degen)
    np.testing.assert_allclose(w, 0.25)
    assert np.isfinite(np.asarray(w)).all()


def test_delta_weights_select_single_particle():
    logw = jnp.full((8,), -jnp.inf).at[3].set(0.0)
    for fn in (systematic_resample, multinomial_resample):
        idx, degen = fn(jax.random.PRNGKey(0), logw)
        assert not bool(degen)
        assert (np.asarray(idx) == 3).all(), fn.__name__


def test_uniform_weights_resample_near_uniform():
    n = 4096
    logw = jnp.zeros((n,))
    idx, _ = systematic_resample(jax.random.PRNGKey(1), logw)
    # systematic resampling of uniform weights is a permutation-free identity
    counts = np.bincount(np.asarray(idx), minlength=n)
    assert counts.max() == 1 and counts.min() == 1


def test_multinomial_counts_match_weights():
    n = 1024
    w = np.random.default_rng(0).dirichlet(np.ones(8))
    # 8 blocks of equal within-block weight; P(block g) = w[g]
    logw = jnp.log(jnp.asarray(np.repeat(w / (n // 8), n // 8), jnp.float32))
    idx, _ = multinomial_resample(jax.random.PRNGKey(2), logw)
    group = np.asarray(idx) // (n // 8)
    freq = np.bincount(group, minlength=8) / n
    np.testing.assert_allclose(freq, w, atol=0.05)


def test_systematic_lower_variance_than_multinomial():
    n = 512
    rng = np.random.default_rng(3)
    logw = jnp.asarray(np.log(rng.dirichlet(np.ones(n)) + 1e-12), jnp.float32)
    w = np.exp(np.asarray(logw))
    w = w / w.sum()

    def offspring_var(fn, trials=64):
        devs = []
        for i in range(trials):
            idx, _ = fn(jax.random.PRNGKey(i), logw)
            counts = np.bincount(np.asarray(idx), minlength=n)
            devs.append(((counts - n * w) ** 2).mean())
        return np.mean(devs)

    v_sys = offspring_var(systematic_resample)
    v_mult = offspring_var(multinomial_resample)
    assert v_sys < v_mult


def test_degenerate_resample_is_identity():
    logw = jnp.full((16,), -jnp.inf)
    idx, degen = systematic_resample(jax.random.PRNGKey(0), logw)
    assert bool(degen)
    np.testing.assert_array_equal(np.asarray(idx), np.arange(16))


def test_batched_resampling():
    logw = jnp.zeros((4, 64))
    idx, degen = systematic_resample(jax.random.PRNGKey(0), logw)
    assert idx.shape == (4, 64)
    assert degen.shape == (4,)


def test_systematic_auto_dispatches_to_scatter_at_threshold(monkeypatch):
    """At n >= SCATTER_THRESHOLD_N (measured crossover, SCALING.json)
    'systematic' silently uses the O(N) scatter kernel; the assignment is
    identical, so the switch is pure kernel selection."""
    from epitpu.smc import resample as rs

    monkeypatch.setattr(rs, "SCATTER_THRESHOLD_N", 64)
    k = jax.random.PRNGKey(3)
    logw = jax.random.normal(jax.random.PRNGKey(4), (128,))
    a, d_a = rs.systematic_resample(k, logw)  # dispatches to scatter
    b, d_b = rs.systematic_resample_scatter(k, logw)
    assert not bool(d_a) and not bool(d_b)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # below the threshold the compare-reduce path still runs and agrees
    monkeypatch.setattr(rs, "SCATTER_THRESHOLD_N", 1 << 30)
    c, _ = rs.systematic_resample(k, logw)
    np.testing.assert_array_equal(np.asarray(c), np.asarray(b))


def test_scatter_systematic_matches_compare_reduce():
    """The O(N) counts+scatter systematic resampler (opt-in below
    SCATTER_THRESHOLD_N, see epitpu/smc/resample.py) computes the SAME ancestor assignment as the
    O(N^2) compare-reduce given the same key, away from measure-zero CDF
    boundary ties."""
    from epitpu.smc import systematic_resample_scatter

    for seed in range(8):
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        logw = jax.random.normal(k1, (513,)) * 3.0
        # sprinkle zero-weight particles (duplicate CDF values)
        logw = logw.at[::7].set(-jnp.inf)
        a, d_a = systematic_resample(k2, logw)
        b, d_b = systematic_resample_scatter(k2, logw)
        assert not bool(d_a) and not bool(d_b)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_scatter_systematic_degenerate_and_delta():
    from epitpu.smc import systematic_resample_scatter

    idx, degen = systematic_resample_scatter(
        jax.random.PRNGKey(0), jnp.full((16,), -jnp.inf)
    )
    assert bool(degen)
    np.testing.assert_array_equal(np.asarray(idx), np.arange(16))

    logw = jnp.full((8,), -jnp.inf).at[3].set(0.0)
    idx, degen = systematic_resample_scatter(jax.random.PRNGKey(1), logw)
    assert not bool(degen)
    assert (np.asarray(idx) == 3).all()


def test_scatter_systematic_batched_and_vmapped():
    from epitpu.smc import systematic_resample_scatter

    logw = jax.random.normal(jax.random.PRNGKey(2), (3, 64))
    idx, degen = systematic_resample_scatter(jax.random.PRNGKey(3), logw)
    assert idx.shape == (3, 64) and degen.shape == (3,)
    # every output row is a valid ancestor vector
    assert (np.asarray(idx) >= 0).all() and (np.asarray(idx) < 64).all()
    # vmap over a batch of keys/weights
    ks = jax.random.split(jax.random.PRNGKey(4), 3)
    idx_v, _ = jax.vmap(systematic_resample_scatter)(ks, logw)
    assert idx_v.shape == (3, 64)


def test_scatter_systematic_counts_match_weights():
    """Offspring counts are within 1 of N*w_k (the defining property of
    systematic resampling)."""
    from epitpu.smc import systematic_resample_scatter

    n = 2048
    w = np.random.default_rng(0).dirichlet(np.ones(16))
    logw = jnp.log(jnp.asarray(np.repeat(w / (n // 16), n // 16)))
    idx, _ = systematic_resample_scatter(jax.random.PRNGKey(5), logw)
    counts = np.bincount(np.asarray(idx), minlength=n)
    expect = n * np.asarray(jnp.exp(logw - jax.scipy.special.logsumexp(logw)))
    assert (np.abs(counts - expect) <= 1.0 + 1e-3).all()

