"""Sharding tests on the 8-virtual-device CPU mesh: tile-sharded rendering is
bit-identical to single-device (the determinism property replacing the
reference's Arc<Mutex> row merging), and the sharded inverse-rendering train
step runs with mesh-wide gradient psum."""
import jax
import jax.numpy as jnp
import numpy as np

from scenes import create_simple_test_scene
from solstrale import RenderConfig
from solstrale.diff import train_step_sharded
from solstrale.parallel import (make_mesh, render_sample_sharded,
                                replicate_scene)
from solstrale.renderer import integrator
from solstrale.scene.compile import compile_scene


def _compiled(w=40, h=16, spp=2):
    scene = create_simple_test_scene(
        RenderConfig(width=w, height=h, samples_per_pixel=spp, seed=1))
    return compile_scene(scene)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_tile_sharded_render_equal():
    """Tile-sharded render equals the single-device render. The RNG is
    counter-based so every shard draws identical sample decisions; the only
    deviation allowed is XLA float reassociation across the two program
    variants (≤ 1e-5)."""
    cs = _compiled()
    kw = dict(width=40, height=16, max_depth=8, shader_kind=0, need_aux=False)
    single, _, _ = integrator.render_sample(cs, jnp.int32(1), jnp.int32(1), **kw)

    mesh = make_mesh(n_tile=8, n_sample=1)
    cs_r = replicate_scene(cs, mesh)
    sharded, _, _ = render_sample_sharded(cs_r, 1, 1, mesh, **kw)
    np.testing.assert_allclose(np.asarray(single), np.asarray(sharded),
                               rtol=1e-5, atol=1e-5)


def test_tile_and_sample_axes():
    """4×2 mesh: 'sample' axis renders 2 consecutive samples and psums —
    equals the sum of two single-device sample passes."""
    cs = _compiled()
    kw = dict(width=40, height=16, max_depth=8, shader_kind=0, need_aux=False)
    s1, _, _ = integrator.render_sample(cs, jnp.int32(5), jnp.int32(1), **kw)
    s2, _, _ = integrator.render_sample(cs, jnp.int32(6), jnp.int32(1), **kw)

    mesh = make_mesh(n_tile=4, n_sample=2)
    cs_r = replicate_scene(cs, mesh)
    both, _, _ = render_sample_sharded(cs_r, 5, 1, mesh, **kw)
    np.testing.assert_allclose(np.asarray(s1 + s2), np.asarray(both),
                               rtol=1e-6, atol=1e-6)


def test_batch_sharded_workqueue_equal():
    """The work-queue wavefront sharded over tiles (render_batch_sharded)
    equals the full-image work-queue render: same estimator, same RNG
    streams, different pixel partitions."""
    from solstrale.parallel import render_batch_sharded

    cs = _compiled()
    kw = dict(width=40, height=16, max_depth=8)
    full, segs_full = integrator.trace_queued(
        cs, None, jnp.int32(1), 2, jnp.int32(1), **kw)
    full_img = full.reshape(16, 40, 3)[::-1]

    mesh = make_mesh(n_tile=4, n_sample=2)
    cs_r = replicate_scene(cs, mesh)
    sharded, segs = render_batch_sharded(cs_r, 1, 2, 1, mesh, **kw)
    np.testing.assert_allclose(np.asarray(full_img), np.asarray(sharded),
                               rtol=1e-5, atol=1e-5)
    assert float(segs) == float(segs_full)


def test_sharded_train_step():
    cs = _compiled(w=16, h=8)
    mesh = make_mesh(n_tile=4, n_sample=2)
    cs_r = replicate_scene(cs, mesh)
    target = jnp.zeros((8 * 16, 3), jnp.float32)
    loss, new_cs = train_step_sharded(cs_r, target, mesh, width=16, height=8,
                                      max_depth=4, lr=1e-2, seed=1)
    assert np.isfinite(float(loss))
    # params actually moved
    assert not np.allclose(np.asarray(new_cs.textures.pixels),
                           np.asarray(cs.textures.pixels))


def test_distributed_single_process():
    """Multi-host helpers degrade gracefully to one process: global mesh over
    the 8 virtual devices, progressive distributed render on host 0."""
    from solstrale.parallel.distributed import (global_mesh, initialize,
                                                render_distributed,
                                                scaling_efficiency)

    n, i = initialize()
    assert (n, i) == (1, 0)
    mesh = global_mesh()
    assert mesh.shape["tile"] * mesh.shape["sample"] == 8

    scene = create_simple_test_scene(
        RenderConfig(width=32, height=16, samples_per_pixel=2, seed=1))
    images = [img for prog, img in render_distributed(scene)]
    assert images[-1] is not None and images[-1].shape == (16, 32, 3)

    eff = scaling_efficiency({1: 100.0, 4: 360.0})
    assert abs(eff[4] - 0.9) < 1e-9


def test_dryrun_multichip_entry():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (32, 64, 3)


def test_sharded_inverse_rendering_converges():
    """End-to-end sharded inverse rendering: N SGD steps through
    train_step_sharded (tile-sharded forward+path-replay backward, mesh-wide
    gradient psum) recover a perturbed texture — the loss against a render
    of the TRUE texture decreases and the recovered arena moves measurably
    closer to the truth (BASELINE.json config 5 capability)."""
    from solstrale import (Bvh, CameraConfig, DiffuseLight, ImageMap,
                           Lambertian, Quad, Scene, Sphere)
    from solstrale.diff import set_texture_params

    rng = np.random.default_rng(2)
    tex = ImageMap(rng.uniform(0.1, 0.9, (4, 4, 3)).astype(np.float32))
    w, h = 24, 12
    scene = Scene(
        Bvh([Quad((-2, 0, -2), (4, 0, 0), (0, 0, 4), Lambertian(tex)),
             Sphere((0, 60, 0), 20.0, DiffuseLight(10, 10, 10))]),
        CameraConfig(vertical_fov_degrees=50.0,
                     look_from=(0.0, 3.0, 0.01), look_at=(0, 0, 0)),
        (0.0, 0.0, 0.0),
        RenderConfig(width=w, height=h, samples_per_pixel=1, seed=1))
    cs_true = compile_scene(scene)

    # target: forward render with the true texture, same estimator config
    # as the training loss (sample 1, early_exit=False);
    # train_step_sharded compares in pixel-id order, so feed it that order
    pix = jnp.arange(w * h, dtype=jnp.int32)
    target = jnp.asarray(np.asarray(integrator.render_pixels(
        cs_true, pix, jnp.int32(1), jnp.int32(7), width=w, height=h,
        max_depth=4, shader_kind=integrator.SHADER_PATH, need_aux=False,
        early_exit=False)[0]))

    true_px = np.asarray(cs_true.textures.pixels)
    noise = rng.normal(0, 0.25, true_px.shape).astype(np.float32)
    cs = set_texture_params(cs_true, jnp.asarray(
        np.clip(true_px + noise, 0.02, 2.0)))

    mesh = make_mesh(n_tile=8, n_sample=1)
    cs = replicate_scene(cs, mesh)
    start_dist = float(np.abs(np.asarray(cs.textures.pixels) - true_px).mean())

    losses = []
    for _ in range(8):
        loss, cs = train_step_sharded(cs, target, mesh, width=w, height=h,
                                      max_depth=4, lr=8.0, seed=7)
        losses.append(float(loss))

    end_dist = float(np.abs(np.asarray(cs.textures.pixels) - true_px).mean())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.7, losses
    # overall downward trend (allow single-step noise)
    assert min(losses) == min(losses[-3:]) or losses[-1] <= min(losses[:3])
    assert end_dist < start_dist, (start_dist, end_dist)


def test_sharded_programs_built_once():
    """Repeated progressive batches reuse one jitted shard_map program
    instead of tracing and compiling the integrator on every call."""
    from solstrale.parallel import _batch_shard_fn, render_batch_sharded

    cs = _compiled(w=16, h=8)
    mesh = make_mesh(n_tile=4, n_sample=2)
    cs_r = replicate_scene(cs, mesh)
    kw = dict(width=16, height=8, max_depth=4)
    a, _ = render_batch_sharded(cs_r, 1, 2, 1, mesh, **kw)
    hits = _batch_shard_fn.cache_info().hits
    b, _ = render_batch_sharded(cs_r, 3, 2, 1, mesh, **kw)
    assert _batch_shard_fn.cache_info().hits == hits + 1
    assert not np.allclose(np.asarray(a), np.asarray(b))
