"""LBVH tests: traversal equivalence vs brute force, on-device build
equivalence, and rendering through the BVH path."""
import jax.numpy as jnp
import numpy as np

from scenes import create_test_scene, new_bvh_test_scene
from solstrale import RenderConfig
from solstrale.accel import (build_bvh, build_bvh_device, bvh_closest_hit,
                             solids_aabbs)
from solstrale.geo import INF, RAY_T_MIN
from solstrale.ops.intersect import closest_solid_hit
from solstrale.scene.compile import compile_scene


def _rand_rays(n, seed=0, spread=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


def test_bvh_matches_brute_force_kitchen_sink():
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1)
    cs = compile_scene(create_test_scene(cfg), use_bvh=False)
    bvh = build_bvh(cs.solids)
    o, d = _rand_rays(512)

    t_b, k_b, i_b = closest_solid_hit(cs.solids, o, d, RAY_T_MIN, INF)
    t_v, k_v, i_v = bvh_closest_hit(bvh, cs.solids, o, d, RAY_T_MIN, INF)

    hit_b = np.isfinite(np.asarray(t_b))
    hit_v = np.isfinite(np.asarray(t_v))
    np.testing.assert_array_equal(hit_b, hit_v)
    np.testing.assert_allclose(np.asarray(t_b)[hit_b], np.asarray(t_v)[hit_v],
                               rtol=1e-5, atol=1e-5)
    # same primitive found (modulo exact ties)
    same = (np.asarray(k_b) == np.asarray(k_v)) & \
        (np.asarray(i_b) == np.asarray(i_v))
    assert same[hit_b].mean() > 0.999


def test_bvh_matches_brute_force_triangle_row():
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1)
    cs = compile_scene(new_bvh_test_scene(cfg, True, 300), use_bvh=False)
    bvh = build_bvh(cs.solids)
    o, d = _rand_rays(512, seed=3, spread=160.0)

    t_b, _, _ = closest_solid_hit(cs.solids, o, d, RAY_T_MIN, INF)
    t_v, _, _ = bvh_closest_hit(bvh, cs.solids, o, d, RAY_T_MIN, INF)
    hit_b = np.isfinite(np.asarray(t_b))
    np.testing.assert_array_equal(hit_b, np.isfinite(np.asarray(t_v)))
    np.testing.assert_allclose(np.asarray(t_b)[hit_b],
                               np.asarray(t_v)[hit_b], rtol=1e-5, atol=1e-5)


def test_on_device_build_matches_host_build():
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1)
    cs = compile_scene(create_test_scene(cfg), use_bvh=False)
    kinds, idxs, mins, maxs = solids_aabbs(cs.solids)

    host = build_bvh(cs.solids)
    dev = build_bvh_device(jnp.asarray(mins, jnp.float32),
                           jnp.asarray(maxs, jnp.float32),
                           jnp.asarray(kinds), jnp.asarray(idxs))
    assert host.node_min.shape == dev.node_min.shape
    o, d = _rand_rays(256)
    t_h, _, _ = bvh_closest_hit(host, cs.solids, o, d, RAY_T_MIN, INF)
    t_d, _, _ = bvh_closest_hit(dev, cs.solids, o, d, RAY_T_MIN, INF)
    hit = np.isfinite(np.asarray(t_h))
    np.testing.assert_array_equal(hit, np.isfinite(np.asarray(t_d)))
    np.testing.assert_allclose(np.asarray(t_h)[hit], np.asarray(t_d)[hit],
                               rtol=1e-5)


def test_render_through_bvh_matches_brute_force():
    from solstrale.renderer import integrator

    cfg = RenderConfig(width=40, height=20, samples_per_pixel=1, seed=1)
    scene = create_test_scene(cfg)
    cs_bf = compile_scene(scene, use_bvh=False)
    cs_bvh = compile_scene(scene, use_bvh=True)
    assert cs_bvh.bvh is not None
    kw = dict(width=40, height=20, max_depth=8, shader_kind=0, need_aux=False)
    a, _, _ = integrator.render_sample(cs_bf, jnp.int32(1), jnp.int32(1), **kw)
    b, _, _ = integrator.render_sample(cs_bvh, jnp.int32(1), jnp.int32(1), **kw)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-4)


def test_compile_scene_device_bvh_matches_host():
    """use_bvh="device" routes the wavefront BVH through the on-device
    LBVH builder; traversal results must match the host build exactly
    (same Morton order => same tree)."""
    import jax.numpy as jnp
    from scenes import create_sponza_class_scene
    from solstrale import RenderConfig
    from solstrale.accel import bvh_closest_hit
    from solstrale.scene.compile import compile_scene

    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1)
    scene = create_sponza_class_scene(cfg, n_cells=40)  # 3200 tris
    cs_h = compile_scene(scene, use_bvh=True)
    cs_d = compile_scene(scene, use_bvh="device")
    assert cs_d.bvh is not None

    rng = np.random.default_rng(3)
    n = 512
    o = jnp.asarray(rng.uniform(-11, 11, (n, 3)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    t_h, k_h, i_h = bvh_closest_hit(cs_h.bvh, cs_h.solids, o, d, 1e-3,
                                    np.inf)
    t_d, k_d, i_d = bvh_closest_hit(cs_d.bvh, cs_d.solids, o, d, 1e-3,
                                    np.inf)
    hit_h = np.isfinite(np.asarray(t_h))
    np.testing.assert_array_equal(hit_h, np.isfinite(np.asarray(t_d)))
    np.testing.assert_allclose(np.asarray(t_h)[hit_h],
                               np.asarray(t_d)[hit_h], rtol=1e-5, atol=1e-5)

    # rebuild cycle: jitter the geometry, rebuild on device, traversal
    # still agrees with a fresh host build of the same moved scene
    scene2 = create_sponza_class_scene(cfg, n_cells=40, seed=9)
    cs_h2 = compile_scene(scene2, use_bvh=True)
    cs_d2 = compile_scene(scene2, use_bvh="device")
    t_h2, _, _ = bvh_closest_hit(cs_h2.bvh, cs_h2.solids, o, d, 1e-3, np.inf)
    t_d2, _, _ = bvh_closest_hit(cs_d2.bvh, cs_d2.solids, o, d, 1e-3, np.inf)
    hh = np.isfinite(np.asarray(t_h2))
    np.testing.assert_array_equal(hh, np.isfinite(np.asarray(t_d2)))
    np.testing.assert_allclose(np.asarray(t_h2)[hh],
                               np.asarray(t_d2)[hh], rtol=1e-5, atol=1e-5)
