"""Math-core unit tests mirroring the reference's vec3/geo doc-tests
(vec3.rs:230-428, geo/mod.rs:243-378, transformation.rs doc examples)."""
import jax.numpy as jnp
import numpy as np
import pytest

from solstrale import geo
from solstrale.geo.transformation import (NopTransformer, RotationX,
                                          RotationY, RotationZ, Scale,
                                          Transformations, Translation)

V = lambda *a: jnp.asarray(a, jnp.float32)


def test_dot_cross():
    assert float(geo.dot(V(1, 2, 3), V(4, 5, 6))) == 32.0
    np.testing.assert_allclose(geo.cross(V(2, 3, 4), V(5, 6, 7)),
                               [-3.0, 6.0, -3.0])


def test_length_unit():
    assert float(geo.length(V(0, 3, 4))) == 5.0
    u = geo.unit(V(0, 3, 4))
    np.testing.assert_allclose(float(geo.length(u)), 1.0, rtol=1e-6)


def test_reflect():
    np.testing.assert_allclose(geo.reflect(V(0, 3, 4), V(0, 1, 0)),
                               [0.0, -3.0, 4.0])
    np.testing.assert_allclose(geo.reflect(V(0, 3, 4), V(0, 0, 1)),
                               [0.0, 3.0, -4.0])


def test_refract_identity():
    v = geo.unit(V(-3, -3, 0))
    out = geo.refract(v, V(0, 1, 0), jnp.float32(1.0))
    np.testing.assert_allclose(out, v, atol=1e-6)


def test_onb():
    t, b, n = geo.onb_from_w(V(0, 0, 2))
    # orthonormal frame with normal = unit(w)
    np.testing.assert_allclose(n, [0, 0, 1], atol=1e-6)
    assert abs(float(geo.dot(t, b))) < 1e-6
    assert abs(float(geo.dot(t, n))) < 1e-6
    v = geo.onb_local(t, b, n, V(0, 0, 1))
    np.testing.assert_allclose(v, n, atol=1e-6)


def test_ray_at():
    p = geo.ray_at(V(1, 0, 0), V(0, 1, 0), jnp.float32(2.0))
    np.testing.assert_allclose(p, [1, 2, 0])


def test_transformations():
    # doc examples from transformation.rs
    np.testing.assert_allclose(
        NopTransformer().transform([1, 2, 3]), [1, 2, 3])
    res = Transformations([RotationY(90.0), Translation([1, 0, 0])]) \
        .transform([1, 0, 0])
    np.testing.assert_allclose(res, [1, 0, -1], atol=1e-12)
    tr = Translation([4, 5, 6])
    np.testing.assert_allclose(tr.transform([1, 2, 3]), [5, 7, 9])
    np.testing.assert_allclose(tr.transform([1, 2, 3], True), [1, 2, 3])
    np.testing.assert_allclose(
        RotationX(90.0).transform([2, 1, 0]), [2, 0, -1], atol=1e-12)
    np.testing.assert_allclose(
        RotationY(90.0).transform([2, 1, 0]), [0, 1, -2], atol=1e-12)
    np.testing.assert_allclose(
        RotationZ(90.0).transform([1, 0, 2]), [0, -1, 2], atol=1e-12)
    np.testing.assert_allclose(
        Scale(3.0).transform([2, 1, 0]), [6, 3, 0])


def test_aabb_helpers():
    lo, hi = geo.aabb_from_points([0, 0, 0], [1, 2, 3], [-1, 1, 1])
    np.testing.assert_allclose(lo, [-1, 0, 0])
    np.testing.assert_allclose(hi, [1, 2, 3])
    lo2, hi2 = geo.pad_aabb_if_needed([0, 0, 0], [1, 0, 1])
    assert hi2[1] - lo2[1] == pytest.approx(geo.PAD_DELTA)
