"""Held-out denoiser evaluation: the learned denoiser (trained on six
fixture scenes, models/train_denoiser.py — the scenes here are NOT among
them) must IMPROVE scenes it never saw, like the reference's pretrained
OIDN net does for arbitrary scenes (post/oidn.rs:33-41). For each held-out
scene: render noisy(4spp) + aux and clean(96spp) references, and require
full-resolution PSNR(denoised, clean) > PSNR(noisy, clean). Full-res PSNR,
not the goldens' blur-downsample similarity: that blur removes most of
the very noise a denoiser exists to remove (a 4spp render already scores
0.98+ on it)."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, "tests")

from scenes import (create_blend_material_scene,
                    create_normal_mapping_sphere_scene, create_uv_scene)
from solstrale import RenderConfig
from solstrale.post import OidnPostProcessor
from solstrale.renderer import integrator
from solstrale.scene.compile import compile_scene
from solstrale.utils import to_rgb_u8


def _psnr(a_u8, b_u8):
    mse = np.mean((a_u8.astype(np.float64) - b_u8.astype(np.float64)) ** 2)
    return 10.0 * np.log10(255.0 ** 2 / max(mse, 1e-9))


def _eval_scene(make_scene, w=96, h=64, noisy_spp=4, clean_spp=96):
    cs = compile_scene(make_scene(
        RenderConfig(width=w, height=h, samples_per_pixel=noisy_spp,
                     seed=5)))
    kw = dict(width=w, height=h, max_depth=50,
              shader_kind=integrator.SHADER_PATH)
    noisy, albedo, normal, _ = integrator.render_sample_batch(
        cs, jnp.int32(1), jnp.int32(5), need_aux=True, n_samples=noisy_spp,
        **kw)
    clean, _, _, _ = integrator.render_sample_batch(
        cs, jnp.int32(500), jnp.int32(5), need_aux=False,
        n_samples=clean_spp, **kw)

    clean_u8 = np.asarray(to_rgb_u8(clean, clean_spp))
    noisy_u8 = np.asarray(to_rgb_u8(noisy, noisy_spp))
    den_u8 = OidnPostProcessor().post_process(
        np.asarray(noisy), np.asarray(albedo), np.asarray(normal),
        w, h, noisy_spp)

    return (_psnr(noisy_u8, clean_u8),
            _psnr(np.asarray(den_u8), clean_u8))


@pytest.mark.slow
@pytest.mark.parametrize("name,maker", [
    ("blend", lambda cfg: create_blend_material_scene(cfg, 0.5)),
    ("uv", create_uv_scene),
    ("normal_sphere",
     lambda cfg: create_normal_mapping_sphere_scene(cfg, (1.5, 2.0, 2.0))),
])
def test_denoiser_improves_held_out_scene(name, maker):
    s_noisy, s_den = _eval_scene(maker)
    if s_noisy > 40.0:
        # the render is essentially noise-free at 4spp (direct lighting):
        # there is nothing to denoise, so the requirement is only that the
        # net does not destroy a clean image
        assert s_den > 30.0, (name, s_noisy, s_den)
    else:
        # the denoiser must not be a fixture-memorizer: it has to beat
        # the raw noisy render on scenes outside its training set
        assert s_den > s_noisy, (name, s_noisy, s_den)
        assert s_den > 20.0, (name, s_den)
