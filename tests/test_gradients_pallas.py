"""Gradients through the traversal kernel: BVH scenes render through the
kernel (interpret mode on CPU) and the detached-geometry ``custom_vjp``
(ops/detached.py) supplies its backward. Gradients must match the
differentiable XLA path for every parameter the framework differentiates
(texture arena, background) — the zero geometry-cotangent is exact for
those (see ops/detached.py docstring)."""
import jax
import jax.numpy as jnp
import numpy as np

from scenes import new_bvh_test_scene
from solstrale import RenderConfig
from solstrale.diff import render_linear, set_texture_params
from solstrale.scene.compile import compile_scene

W, H, DEPTH, SAMPLES, SEED = 16, 8, 4, 1, 1
CFG = RenderConfig(width=W, height=H, samples_per_pixel=SAMPLES, seed=SEED)


def _loss(cs):
    def f(p):
        img = render_linear(set_texture_params(cs, p), width=W, height=H,
                            max_depth=DEPTH, n_samples=SAMPLES, seed=SEED)
        return jnp.sum(img)

    return f


def _grad(cs, params):
    return jax.jit(jax.grad(_loss(cs)))(params)


def test_pallas_grad_matches_xla_sweep(kernel_interpret):
    """Triangle row lit by a sphere light: the kernel path (kernel plus
    the XLA sphere sweep) gives the brute-force XLA sweep's gradient."""
    scene = new_bvh_test_scene(CFG, use_bvh=True, num_triangles=64)
    cs = compile_scene(scene, use_bvh=True)
    assert cs.kbvh is not None
    g_kernel = np.asarray(_grad(cs, cs.textures.pixels))
    cs_sweep = compile_scene(scene, use_bvh=False)
    g_xla = np.asarray(_grad(cs_sweep, cs_sweep.textures.pixels))

    assert np.isfinite(g_kernel).all()
    assert (np.abs(g_kernel) > 0).any()
    # same estimator, same RNG; only kernel-vs-XLA fp evaluation order
    # differs, which can flip a borderline hit decision on a handful of rays
    np.testing.assert_allclose(g_kernel, g_xla, rtol=1e-3, atol=1e-4)


def test_pallas_grad_bvh_scene(kernel_interpret):
    """Triangle-row BVH scene: kernel gradient equals the XLA walk's."""
    scene = new_bvh_test_scene(CFG, use_bvh=True, num_triangles=64)
    cs = compile_scene(scene, use_bvh=True)
    assert cs.bvh is not None and cs.kbvh is not None
    g = np.asarray(_grad(cs, cs.textures.pixels))
    assert np.isfinite(g).all()
    assert (np.abs(g) > 0).any()

    import dataclasses

    cs_walk = dataclasses.replace(cs, kbvh=None)
    g_xla = np.asarray(_grad(cs_walk, cs_walk.textures.pixels))
    np.testing.assert_allclose(g, g_xla, rtol=1e-3, atol=1e-4)


def test_pallas_grad_finite_differences(kernel_interpret):
    """FD check directly against the kernel-path forward (counter-based
    RNG => same paths probed)."""
    cs = compile_scene(new_bvh_test_scene(CFG, use_bvh=True,
                                          num_triangles=64), use_bvh=True)
    params = cs.textures.pixels
    f = _loss(cs)
    fj = jax.jit(f)
    g = np.asarray(jax.jit(jax.grad(f))(params))
    eps = 1e-3
    probes = [(i, c) for i in range(min(params.shape[0], 2))
              for c in (0, 2)]
    for i, c in probes:
        fd = (float(fj(params.at[i, c].add(eps)))
              - float(fj(params.at[i, c].add(-eps)))) / (2 * eps)
        np.testing.assert_allclose(g[i, c], fd, rtol=2e-2, atol=2e-2)
