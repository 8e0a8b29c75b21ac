"""Train the DenoiserCNN on this renderer's own output: noisy low-spp
renders (+albedo/normal aux) → high-spp targets. The learned replacement for
the reference's pretrained OIDN binary (post/oidn.rs), kept inside the
differentiable graph.

Usage: python -m solstrale.models.train_denoiser [steps] [out.pkl]
"""
from __future__ import annotations

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np


def _training_scenes(size=128):
    """Training fixtures. The held-out evaluation set
    (tests/test_denoiser_heldout.py: blend, uv, normal-mapped sphere) must
    NEVER appear here — the generality claim rests on that split."""
    sys.path.insert(0, "tests")
    from solstrale import RotationY
    from scenes import (create_light_attenuation_scene,
                        create_normal_mapping_scene, create_obj_scene,
                        create_quad_rotation_scene,
                        create_simple_test_scene, create_test_scene)
    from solstrale import RenderConfig

    def cfg(spp):
        return RenderConfig(width=size, height=size, samples_per_pixel=spp,
                            seed=3)

    def textured_sphere(spp):
        # image-textured sphere + ground: trains albedo-guided detail
        # preservation WITHOUT the held-out uv scene's texture
        from solstrale import (Bvh, CameraConfig, DiffuseLight,
                               ImageMap, Lambertian, Quad, Scene,
                               SolidColor, Sphere)
        REF = "/root/reference"
        world = [
            Sphere((0, 1, 0), 1.0,
                   Lambertian(ImageMap.load(f"{REF}/resources/textures/tex.jpg"))),
            Quad((-6, 0, -6), (12, 0, 0), (0, 0, 12),
                 Lambertian(SolidColor(0.5, 0.5, 0.5))),
            Sphere((3, 6, 3), 1.5, DiffuseLight(20, 20, 20)),
        ]
        cam = CameraConfig(vertical_fov_degrees=35.0,
                           look_from=(0, 2.0, 4.0), look_at=(0, 1, 0))
        return Scene(Bvh(world), cam, (0.1, 0.15, 0.3), cfg(spp))

    return [
        lambda spp: create_test_scene(cfg(spp)),
        lambda spp: create_simple_test_scene(cfg(spp)),
        lambda spp: create_light_attenuation_scene(cfg(spp), 0.8),
        lambda spp: create_light_attenuation_scene(cfg(spp), 2.0),
        lambda spp: create_quad_rotation_scene(cfg(spp), RotationY(45.0)),
        lambda spp: create_obj_scene(cfg(spp)),
        # quad normal-mapping fixture (the SPHERE variant stays held out)
        lambda spp: create_normal_mapping_scene(cfg(spp), (1.5, 2.0, 2.0),
                                                True),
        textured_sphere,
    ]


def _render_pair(make_scene, noisy_spp=4, clean_spp=128, size=128):
    from ..renderer import integrator
    from ..scene.compile import compile_scene
    from ..utils import to_float

    cs = compile_scene(make_scene(noisy_spp))
    kw = dict(width=size, height=size, max_depth=50,
              shader_kind=integrator.SHADER_PATH)
    noisy, albedo, normal, _ = integrator.render_sample_batch(
        cs, jnp.int32(1), jnp.int32(3), need_aux=True, n_samples=noisy_spp,
        **kw)
    clean, _, _, _ = integrator.render_sample_batch(
        cs, jnp.int32(1000), jnp.int32(3), need_aux=False,
        n_samples=clean_spp, **kw)
    return (np.asarray(to_float(noisy, noisy_spp)),
            np.asarray(to_float(albedo, noisy_spp)),
            np.asarray(normal) / noisy_spp,
            np.asarray(to_float(clean, clean_spp)))


def train(steps=600, out_path="solstrale/models/denoiser_weights.pkl",
          size=128, noisy_spp=4, clean_spp=128):
    import optax

    from .denoiser import DenoiserCNN

    print("rendering training pairs...")
    # noise-level variety (2/4/8 spp) + flip augmentation: the net must
    # denoise, not memorize the three round-3 fixtures (the round-3
    # weights LOWERED held-out-scene similarity below the raw noisy input)
    pairs = []
    for m in _training_scenes(size):
        for spp in (2, 4, 8):
            pairs.append(_render_pair(m, spp, clean_spp, size))
    pairs += [tuple(np.ascontiguousarray(a[:, ::-1]) for a in p)
              for p in pairs]
    pairs += [tuple(np.ascontiguousarray(a[::-1]) for a in p)
              for p in pairs[:len(pairs) // 2]]
    print(f"{len(pairs)} training pairs")

    model = DenoiserCNN()
    params = model.init(jax.random.PRNGKey(0),
                        *(jnp.asarray(p) for p in pairs[0][:3]))
    opt = optax.adam(optax.cosine_decay_schedule(1e-3, steps))
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, noisy, albedo, normal, clean):
        def loss_fn(p):
            out = model.apply(p, noisy, albedo, normal)
            return jnp.mean(jnp.abs(out - clean))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    rng_np = np.random.default_rng(0)
    order = rng_np.permutation(len(pairs))
    for i in range(steps):
        noisy, albedo, normal, clean = pairs[order[i % len(pairs)]]
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(noisy),
                                       jnp.asarray(albedo),
                                       jnp.asarray(normal),
                                       jnp.asarray(clean))
        if i % 25 == 0:
            print(f"step {i}: L1 {float(loss):.5f}")

    with open(out_path, "wb") as f:
        pickle.dump(jax.device_get(params), f)
    print("saved", out_path)
    return params


if __name__ == "__main__":
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    out = sys.argv[2] if len(sys.argv) > 2 else \
        "solstrale/models/denoiser_weights.pkl"
    train(steps, out)
