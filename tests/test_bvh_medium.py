"""Constant media on the BVH path: a large (BVH-routed) scene wrapped in
fog must produce finite, medium-affected renders identical between the
traversal kernel and the brute-force path (scene_hit applies medium_hit
AFTER the solid hit — integrator.scene_hit, constant_medium.rs:35-79)."""
import jax.numpy as jnp
import numpy as np

from scenes import create_sponza_class_scene
from solstrale import (Bvh, ConstantMedium, RenderConfig, Scene,
                       new_box)
from solstrale.renderer import integrator
from solstrale.scene.compile import compile_scene
from solstrale.scene.materials import Lambertian
from solstrale.scene.textures import SolidColor


def _foggy_scene(cfg, n_cells=36):
    base = create_sponza_class_scene(cfg, n_cells=n_cells, textured=False)
    world = list(base.world.children) + [
        ConstantMedium(Bvh(new_box((-8, -1, -8), (8, 8, 8),
                                   Lambertian(SolidColor(1, 1, 1)))),
                       0.05, (0.9, 0.9, 0.9)),
    ]
    return Scene(Bvh(world), base.camera, base.background_color, cfg)


def test_bvh_scene_with_medium_matches_brute(kernel_interpret):
    w, h = 32, 20
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=2, seed=2)
    scene = _foggy_scene(cfg)

    cs_bvh = compile_scene(scene, use_bvh=True)
    assert cs_bvh.kbvh is not None and len(cs_bvh.media) == 1
    cs_brute = compile_scene(scene, use_bvh=False)

    img_b, _, _, segs_b = integrator.render_sample_batch(
        cs_bvh, jnp.int32(0), jnp.int32(2), width=w, height=h,
        max_depth=12, shader_kind=0, need_aux=False, n_samples=2)
    img_r, _, _, segs_r = integrator.render_sample_batch(
        cs_brute, jnp.int32(0), jnp.int32(2), width=w, height=h,
        max_depth=12, shader_kind=0, need_aux=False, n_samples=2)

    img_b = np.asarray(img_b)
    img_r = np.asarray(img_r)
    assert np.isfinite(img_b).all() and img_b.mean() > 0
    # identical RNG + identical medium events => same estimator values
    # (fp reassociation between the two intersection forms only)
    np.testing.assert_allclose(img_b, img_r, rtol=5e-3, atol=5e-3)
    # segment counts may differ by a few paths: hit t values differ in ulps
    # between the kernel and the sweep (different fp evaluation order), and
    # a near-threshold scatter/termination decision can flip
    np.testing.assert_allclose(float(segs_b), float(segs_r), rtol=1e-3)
