"""Checkpoint/resume equivalence: a render interrupted at sample k and
resumed from the saved accumulation state produces the same final image as
an uninterrupted run (counter-based RNG guarantees the identical remaining
samples)."""
import os
import tempfile

import numpy as np

from scenes import create_simple_test_scene
from solstrale import RenderConfig, Renderer
from solstrale.geo import ray_shortest_distance


def _scene(spp):
    return create_simple_test_scene(
        RenderConfig(width=24, height=12, samples_per_pixel=spp, seed=1))


def test_resume_matches_straight_run():
    straight = Renderer(_scene(4)).render_final()

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.npz")
        # run only 2 samples, checkpointing
        n = [0]
        r = Renderer(_scene(4))
        for _ in r.render(abort=lambda: n[0] >= 2, checkpoint_path=ck,
                          checkpoint_every=1):
            n[0] += 1
        assert os.path.exists(ck)

        # resume to completion
        resumed_img = None
        for p in Renderer(_scene(4)).render(resume_from=ck):
            if p.render_image is not None:
                resumed_img = p.render_image
    np.testing.assert_array_equal(np.asarray(straight),
                                  np.asarray(resumed_img))


def test_ray_shortest_distance():
    import jax.numpy as jnp

    # parallel rays distance 2 (geo/mod.rs doc tests)
    d = ray_shortest_distance(jnp.asarray([0.0, 0, 0]), jnp.asarray([1.0, 0, 0]),
                              jnp.asarray([0.0, 2, 0]), jnp.asarray([1.0, 0, 0]))
    assert float(d) == 2.0
    # skew rays
    d = ray_shortest_distance(jnp.asarray([0.0, 0, 0]), jnp.asarray([1.0, 0, 0]),
                              jnp.asarray([0.0, 0, 3]), jnp.asarray([0.0, 1, 0]))
    assert abs(float(d) - 3.0) < 1e-6
