"""Counter-based RNG tests: determinism, ranges, distribution moments,
sharding invariance (the property the reference's thread-local fastrand
fundamentally lacks, random.rs:4-21)."""
import jax.numpy as jnp
import numpy as np

from solstrale.ops import rng


def test_uniform_range_and_determinism():
    pix = jnp.arange(10_000)
    a = rng.uniform(pix, 3, 1, rng.P_COSINE, 7)
    b = rng.uniform(pix, 3, 1, rng.P_COSINE, 7)
    np.testing.assert_array_equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    # roughly uniform
    assert abs(float(a.mean()) - 0.5) < 0.01


def test_streams_decorrelated():
    pix = jnp.arange(10_000)
    a = rng.uniform(pix, 3, 1, rng.P_COSINE, 7)
    b = rng.uniform(pix, 3, 1, rng.P_MIX_COIN, 7)
    c = rng.uniform(pix, 4, 1, rng.P_COSINE, 7)
    d = rng.uniform(pix, 3, 2, rng.P_COSINE, 7)
    e = rng.uniform(pix, 3, 1, rng.P_COSINE, 8)
    for other in (b, c, d, e):
        assert abs(float(jnp.corrcoef(a, other)[0, 1])) < 0.03


def test_shape_invariance():
    """Values depend only on the logical counters, never on batch shape —
    the property that makes any sharding bit-reproducible."""
    full = rng.uniform(jnp.arange(1000), 1, 0, rng.P_JITTER, 3)
    lo = rng.uniform(jnp.arange(0, 500), 1, 0, rng.P_JITTER, 3)
    hi = rng.uniform(jnp.arange(500, 1000), 1, 0, rng.P_JITTER, 3)
    np.testing.assert_array_equal(full, jnp.concatenate([lo, hi]))


def test_unit_vector_distribution():
    pix = jnp.arange(20_000)
    r1 = rng.uniform(pix, 0, 0, rng.P_COSINE, 1)
    r2 = rng.uniform(pix, 0, 0, rng.P_MIX_COIN, 1)
    v = rng.unit_vector(r1, r2)
    lens = jnp.linalg.norm(v, axis=-1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-5)
    # mean ≈ 0 for uniform sphere
    assert float(jnp.abs(v.mean(0)).max()) < 0.02


def test_cosine_direction_distribution():
    pix = jnp.arange(20_000)
    r1 = rng.uniform(pix, 0, 0, rng.P_COSINE, 2)
    r2 = rng.uniform(pix, 0, 0, rng.P_MIX_COIN, 2)
    v = rng.cosine_direction(r1, r2)
    lens = jnp.linalg.norm(v, axis=-1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-5)
    assert float(v[:, 2].min()) >= 0.0
    # E[cos theta] = 2/3 for cosine-weighted hemisphere
    assert abs(float(v[:, 2].mean()) - 2.0 / 3.0) < 0.01


def test_in_unit_sphere_and_disc():
    pix = jnp.arange(20_000)
    r = [rng.uniform(pix, 0, 0, p, 5) for p in range(3)]
    v = rng.in_unit_sphere(*r)
    assert float(jnp.linalg.norm(v, axis=-1).max()) <= 1.0
    # E[r] for uniform ball = 3/4
    assert abs(float(jnp.linalg.norm(v, axis=-1).mean()) - 0.75) < 0.01
    d = rng.in_unit_disc(r[0], r[1])
    assert float(jnp.linalg.norm(d, axis=-1).max()) <= 1.0
    np.testing.assert_array_equal(d[:, 2], 0.0)


def test_to_sphere_within_cone():
    pix = jnp.arange(10_000)
    r1 = rng.uniform(pix, 0, 0, 0, 9)
    r2 = rng.uniform(pix, 0, 0, 1, 9)
    radius, dist_sq = 1.0, 25.0
    v = rng.to_sphere(radius, dist_sq, r1, r2)
    cos_theta_max = np.sqrt(1 - radius * radius / dist_sq)
    assert float(v[:, 2].min()) >= cos_theta_max - 1e-5
