"""Differentiability tests: autodiff (detached-sampling path replay) must
agree with finite differences under matched RNG counters for parameters that
do not alter sampling decisions (albedo, emission) — the BASELINE.json
pixel-gradient allclose requirement."""
import pytest

import jax
import jax.numpy as jnp
import numpy as np

from scenes import create_simple_test_scene
from solstrale import RenderConfig
from solstrale.diff import render_linear, set_texture_params
from solstrale.scene.compile import compile_scene

W, H, DEPTH, SAMPLES, SEED = 24, 12, 6, 2, 1


def _cs():
    scene = create_simple_test_scene(
        RenderConfig(width=W, height=H, samples_per_pixel=SAMPLES, seed=SEED))
    return compile_scene(scene)


def _image_sum(cs, params, weight):
    img = render_linear(set_texture_params(cs, params), width=W, height=H,
                        max_depth=DEPTH, n_samples=SAMPLES, seed=SEED)
    return jnp.sum(img * weight)


def test_grad_matches_finite_differences():
    cs = _cs()
    params = cs.textures.pixels
    # random projection weight so the scalar probes all pixels
    key = jax.random.PRNGKey(0)
    weight = jax.random.uniform(key, (W * H, 3))

    f = jax.jit(lambda p: _image_sum(cs, p, weight))
    grad = jax.jit(jax.grad(lambda p: _image_sum(cs, p, weight)))(params)
    grad = np.asarray(grad)

    eps = 1e-3
    # probe several arena entries: the light color (emission) and the
    # sphere albedo
    probes = [(i, c) for i in range(min(params.shape[0], 3))
              for c in range(3)]
    for i, c in probes:
        p_plus = params.at[i, c].add(eps)
        p_minus = params.at[i, c].add(-eps)
        fd = (float(f(p_plus)) - float(f(p_minus))) / (2 * eps)
        ad = grad[i, c]
        np.testing.assert_allclose(
            ad, fd, rtol=2e-2, atol=2e-2,
            err_msg=f"grad mismatch at arena[{i},{c}]")


def test_grad_nonzero_and_finite():
    cs = _cs()
    weight = jnp.ones((W * H, 3))
    grad = jax.jit(jax.grad(
        lambda p: _image_sum(cs, p, weight)))(cs.textures.pixels)
    g = np.asarray(grad)
    assert np.isfinite(g).all()
    assert (np.abs(g) > 0).any()


@pytest.mark.slow
def test_grad_at_depth50_memory_bounded():
    """The checkpointed (path-replay) backward holds only chunk-boundary
    carries, so a full-size 300x200 @ depth-50 gradient runs without
    materializing the per-bounce wavefront (VERDICT r1 item 6). A flat scan
    tape at this size would need tens of GB."""
    w, h = 300, 200
    scene = create_simple_test_scene(
        RenderConfig(width=w, height=h, samples_per_pixel=1, seed=SEED))
    cs = compile_scene(scene)

    def f(p):
        img = render_linear(set_texture_params(cs, p), width=w, height=h,
                            max_depth=50, n_samples=1, seed=SEED)
        return jnp.sum(img)

    grad = np.asarray(jax.jit(jax.grad(f))(cs.textures.pixels))
    assert np.isfinite(grad).all()
    assert (np.abs(grad) > 0).any()


def test_background_gradient():
    """Gradient w.r.t. the background color flows through misses."""
    import dataclasses

    cs = _cs()

    def f(bg):
        cs2 = dataclasses.replace(cs, bg_color=bg)
        img = render_linear(cs2, width=W, height=H, max_depth=DEPTH,
                            n_samples=1, seed=SEED)
        return jnp.sum(img)

    g = np.asarray(jax.grad(f)(cs.bg_color))
    assert np.isfinite(g).all() and (g > 0).all()
