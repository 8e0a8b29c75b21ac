"""Renderer host-loop behavior: progress protocol, abort, image strategies,
post chain plumbing, determinism (renderer/mod.rs:209-358)."""
import numpy as np
import pytest

from scenes import create_simple_test_scene
from solstrale import (EverySample, Interval, RenderConfig,
                       Renderer, ray_trace)


def _cfg(**kw):
    kw.setdefault("width", 40)
    kw.setdefault("height", 20)
    kw.setdefault("samples_per_pixel", 3)
    kw.setdefault("seed", 1)
    return RenderConfig(**kw)


def test_progress_sequence():
    scene = create_simple_test_scene(_cfg())
    reports = list(ray_trace(scene))
    assert len(reports) == 3
    np.testing.assert_allclose([r.progress for r in reports],
                               [1 / 3, 2 / 3, 1.0])
    assert all(r.fps is not None and r.fps > 0 for r in reports)
    assert reports[-1].estimated_time_left == 0.0
    # OnlyFinal default: image only on the last report
    assert reports[0].render_image is None
    assert reports[-1].render_image is not None
    assert reports[-1].render_image.shape == (20, 40, 3)


def test_every_sample_strategy():
    scene = create_simple_test_scene(
        _cfg(render_image_strategy=EverySample()))
    reports = list(ray_trace(scene))
    assert all(r.render_image is not None for r in reports)


def test_interval_strategy_always_has_final():
    scene = create_simple_test_scene(
        _cfg(render_image_strategy=Interval(seconds=9999.0)))
    reports = list(ray_trace(scene))
    assert reports[-1].render_image is not None


def test_abort():
    scene = create_simple_test_scene(_cfg(samples_per_pixel=10))
    count = 0

    def abort():
        return count >= 2

    reports = []
    for r in ray_trace(scene, abort=abort):
        reports.append(r)
        count += 1
    assert len(reports) == 2  # aborted after two samples


def test_no_light_error():
    scene = create_simple_test_scene(_cfg(), add_light=False)
    with pytest.raises(ValueError,
                       match="Scene should have at least one light"):
        Renderer(scene)


def test_deterministic_given_seed():
    a = Renderer(create_simple_test_scene(_cfg())).render_final()
    b = Renderer(create_simple_test_scene(_cfg())).render_final()
    np.testing.assert_array_equal(a, b)


def test_seed_changes_noise():
    a = Renderer(create_simple_test_scene(_cfg(seed=1))).render_final()
    b = Renderer(create_simple_test_scene(_cfg(seed=2))).render_final()
    assert (np.asarray(a) != np.asarray(b)).any()


def test_albedo_normal_shaders():
    from solstrale import AlbedoShader, NormalShader

    img_a = Renderer(create_simple_test_scene(
        _cfg(samples_per_pixel=2, shader=AlbedoShader()))).render_final()
    # albedo of the yellow sphere center ≈ sqrt(1,1,0) scaled
    center = np.asarray(img_a)[10, 20]
    assert center[0] > 200 and center[1] > 200 and center[2] < 30
    img_n = Renderer(create_simple_test_scene(
        _cfg(samples_per_pixel=2, shader=NormalShader()))).render_final()
    assert np.asarray(img_n).std() > 0  # non-degenerate


def test_checkpoint_resume_equivalence():
    """Progressive accumulation = checkpointable state: rendering samples
    [1..3] in one go equals accumulating two runs over [1..2] and [3..3]
    (the explicit sum+counter checkpoint of SURVEY §5)."""
    import jax.numpy as jnp

    from solstrale.renderer import integrator
    from solstrale.scene.compile import compile_scene

    scene = create_simple_test_scene(_cfg())
    cs = compile_scene(scene)
    kw = dict(width=40, height=20, max_depth=50, shader_kind=0,
              need_aux=False)

    total = None
    for s in range(1, 4):
        c, _, _ = integrator.render_sample(cs, jnp.int32(s), jnp.int32(1), **kw)
        total = c if total is None else total + c
    # resume: re-render only sample 3 and add to a checkpoint of [1..2]
    ckpt = None
    for s in range(1, 3):
        c, _, _ = integrator.render_sample(cs, jnp.int32(s), jnp.int32(1), **kw)
        ckpt = c if ckpt is None else ckpt + c
    c3, _, _ = integrator.render_sample(cs, jnp.int32(3), jnp.int32(1), **kw)
    np.testing.assert_allclose(np.asarray(total), np.asarray(ckpt + c3),
                               rtol=1e-6, atol=1e-6)
