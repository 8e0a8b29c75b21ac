"""Intersection sweep unit tests with analytically-known hits."""
import jax.numpy as jnp
import numpy as np
import pytest

from solstrale import (Bvh, CameraConfig, ConstantMedium, DiffuseLight,
                       Lambertian, Quad, RenderConfig, Scene, SolidColor,
                       Sphere, Triangle, new_box)
from solstrale.geo import INF, RAY_T_MIN
from solstrale.ops.intersect import (closest_solid_hit, hit_attributes,
                                     light_pdf_values, medium_hit)
from solstrale.scene.compile import (KIND_QUAD, KIND_SPHERE,
                                     KIND_TRIANGLE, compile_scene)

V = lambda *a: jnp.asarray([a], jnp.float32)


def _compile(world):
    scene = Scene(Bvh(world + [Sphere((0, 50, 0), 1.0, DiffuseLight(1, 1, 1))]),
                  CameraConfig(look_from=(0, 0, 4)), (0, 0, 0),
                  RenderConfig(width=4, height=4))
    return compile_scene(scene)


def test_sphere_hit():
    cs = _compile([Sphere((0, 0, 0), 1.0, Lambertian(SolidColor(1, 1, 0)))])
    t, kind, idx = closest_solid_hit(cs.solids, V(0, 0, 4), V(0, 0, -1),
                                     RAY_T_MIN, INF)
    assert float(t[0]) == pytest.approx(3.0, abs=1e-5)
    assert int(kind[0]) == KIND_SPHERE

    attrs = hit_attributes(cs.solids, V(0, 0, 4), V(0, 0, -1), t, kind, idx)
    np.testing.assert_allclose(attrs["point"][0], [0, 0, 1], atol=1e-5)
    np.testing.assert_allclose(attrs["normal"][0], [0, 0, 1], atol=1e-5)
    assert bool(attrs["front_face"][0])
    # sphere UV at +z front: phi = -atan2(1, 0) + pi = pi/2 → u = 0.25
    np.testing.assert_allclose(attrs["uv"][0], [0.25, 0.5], atol=1e-4)

    # inside the sphere: far root, flipped normal, back face
    t, kind, idx = closest_solid_hit(cs.solids, V(0, 0, 0), V(0, 0, -1),
                                     RAY_T_MIN, INF)
    assert float(t[0]) == pytest.approx(1.0, abs=1e-5)
    attrs = hit_attributes(cs.solids, V(0, 0, 0), V(0, 0, -1), t, kind, idx)
    assert not bool(attrs["front_face"][0])
    np.testing.assert_allclose(attrs["normal"][0], [0, 0, 1], atol=1e-5)


def test_quad_hit_and_uv():
    cs = _compile([Quad((-1, -1, 0), (2, 0, 0), (0, 2, 0),
                        Lambertian(SolidColor(1, 1, 0)))])
    t, kind, idx = closest_solid_hit(cs.solids, V(0.5, -0.5, 2), V(0, 0, -1),
                                     RAY_T_MIN, INF)
    assert float(t[0]) == pytest.approx(2.0, abs=1e-5)
    assert int(kind[0]) == KIND_QUAD
    attrs = hit_attributes(cs.solids, V(0.5, -0.5, 2), V(0, 0, -1), t, kind, idx)
    np.testing.assert_allclose(attrs["uv"][0], [0.75, 0.25], atol=1e-5)
    # miss outside [0,1]^2
    t, _, _ = closest_solid_hit(cs.solids, V(1.5, 0, 2), V(0, 0, -1),
                                RAY_T_MIN, INF)
    assert not bool(jnp.isfinite(t[0]))


def test_triangle_hit_uv_interp():
    tri = Triangle.new_with_tex_coords(
        (-1, 0, 0), (1, 0, 0), (0, 2, 0), (0, 0), (1, 0), (0.5, 1),
        Lambertian(SolidColor(1, 1, 0)))
    cs = _compile([tri])
    o, d = V(0, 0.5, 3), V(0, 0, -1)
    t, kind, idx = closest_solid_hit(cs.solids, o, d, RAY_T_MIN, INF)
    assert float(t[0]) == pytest.approx(3.0, abs=1e-5)
    assert int(kind[0]) == KIND_TRIANGLE
    attrs = hit_attributes(cs.solids, o, d, t, kind, idx)
    # barycentric at (0, 0.5): b1 = b2 = 0.25 → uv = (0.5, 0.25)
    np.testing.assert_allclose(attrs["uv"][0], [0.5, 0.25], atol=1e-4)


def test_tmin_epsilon():
    cs = _compile([Sphere((0, 0, 0), 1.0, Lambertian(SolidColor(1, 1, 0)))])
    # origin on the surface: nearest root ~0 rejected by RAY_T_MIN,
    # far root 2 accepted
    t, _, _ = closest_solid_hit(cs.solids, V(0, 0, 1), V(0, 0, -1),
                                RAY_T_MIN, INF)
    assert float(t[0]) == pytest.approx(2.0, abs=1e-4)


def test_medium_entry_exit():
    red = Lambertian(SolidColor(1, 0, 0))
    cs = _compile([ConstantMedium(Bvh(new_box((-1, -1, -1), (1, 1, 1), red)),
                                  1000.0, (1, 1, 1))])
    med = cs.media[0]
    o, d = V(0, 0, 5), V(0, 0, -1)
    # huge density → scatters essentially at entry (t=4)
    t = medium_hit(med, o, d, jnp.asarray([INF]), jnp.asarray([0.5]))
    assert float(t[0]) == pytest.approx(4.0, abs=0.01)
    # u≈1 → ln→0 → scatter exactly at entry
    t = medium_hit(med, o, d, jnp.asarray([INF]), jnp.asarray([0.999999]))
    assert float(t[0]) == pytest.approx(4.0, abs=1e-3)
    # solid occluder before entry → no medium event
    t = medium_hit(med, o, d, jnp.asarray([3.0]), jnp.asarray([0.5]))
    assert not bool(jnp.isfinite(t[0]))


def test_light_pdf_sphere():
    cs = _compile([])  # just the light at (0,50,0) r=1
    o = V(0, 0, 0)
    d = V(0, 1, 0)  # straight at the light
    pdf = light_pdf_values(cs.lights, o, d)
    # solid angle = 2π(1−sqrt(1−1/2500))
    expected = 1.0 / (2 * np.pi * (1 - np.sqrt(1 - 1.0 / 2500.0)))
    assert float(pdf[0, 0]) == pytest.approx(expected, rel=1e-3)
    # pointing away → 0
    pdf = light_pdf_values(cs.lights, o, V(0, -1, 0))
    assert float(pdf[0, 0]) == 0.0


def test_light_pdf_quad():
    light = DiffuseLight(1, 1, 1)
    scene = Scene(
        Bvh([Quad((-1, -1, 5), (2, 0, 0), (0, 2, 0), light)]),
        CameraConfig(look_from=(0, 0, 4)), (0, 0, 0),
        RenderConfig(width=4, height=4))
    cs = compile_scene(scene)
    pdf = light_pdf_values(cs.lights, V(0, 0, 0), V(0, 0, 1))
    # head-on: dist²/(cos·area) = 25/(1·4)
    assert float(pdf[0, 0]) == pytest.approx(25.0 / 4.0, rel=1e-4)


def test_light_pdf_mean3_vectorized_fallback_matches_unroll():
    """Above _MEAN3_UNROLL_MAX lights the SoA mean switches to the
    vectorized (R, L) sweep; both forms must agree exactly on a mixed
    sphere/quad/triangle light set."""
    from solstrale.ops import intersect as X
    from solstrale.geo import soa

    rng = np.random.default_rng(11)
    world = []
    for i in range(9):
        world.append(Sphere((i * 2.0 - 8, 30 + i, 0), 0.5 + 0.1 * i,
                            DiffuseLight(5, 5, 5)))
    for i in range(9):
        world.append(Quad((i * 2.0 - 8, -20.0, -3), (1, 0, 0), (0, 0, 1),
                          DiffuseLight(4, 4, 4)))
    scene = Scene(Bvh(world), CameraConfig(look_from=(0, 0, 25)), (0, 0, 0),
                  RenderConfig(width=4, height=4))
    cs = compile_scene(scene)
    assert cs.lights.kind.shape[0] > X._MEAN3_UNROLL_MAX

    n = 64
    o = jnp.asarray(rng.uniform(-5, 5, (n, 3)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    o_s, d_s = soa.from_aos(o), soa.from_aos(d)

    got = X.light_pdf_mean3(cs.lights, o_s, d_s)        # fallback path
    want = jnp.mean(X.light_pdf_values(cs.lights, o, d), axis=1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-7)

    # and the unrolled form itself agrees on a small subset scene
    few = Scene(Bvh(world[:3]), CameraConfig(look_from=(0, 0, 25)),
                (0, 0, 0), RenderConfig(width=4, height=4))
    cf = compile_scene(few)
    got2 = X.light_pdf_mean3(cf.lights, o_s, d_s)
    want2 = jnp.mean(X.light_pdf_values(cf.lights, o, d), axis=1)
    np.testing.assert_allclose(np.asarray(got2), np.asarray(want2),
                               rtol=1e-5, atol=1e-7)
