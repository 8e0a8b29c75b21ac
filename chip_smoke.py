"""On-card smoke test: drives the render path once at full width on a GPU
and checks each result against the repo's plain reference.

    python chip_smoke.py               # one card, phases (a)-(f)
    python chip_smoke.py --four-cards  # only the 4-card sharded render

Phases on one card:
  (a) device: the platform must be ``gpu``; prints the card's name and
      power limit (nvidia-smi);
  (b) traversal kernel vs the XLA walk at sponza shape (131,072 rays into
      262,088 triangles): agreement and time of both (host clock around
      block_until_ready, alternated kernel/walk/walk/kernel after warm-up);
  (c) ``ray_trace`` on the textured sponza-class scene at 1920x1080, 2 spp,
      depth 50, and the same frame through the XLA walk;
  (d) the kitchen-sink analogue without a BVH (constant medium, every
      material kind) at 400x266 @ 8 spp through ``render_sample_batch``,
      checked against per-sample ``render_sample`` passes;
  (e) three inverse-rendering SGD steps through
      ``diff.image_and_texture_grad`` on a BVH fixture at 320x180;
  (f) same-seed determinism of two renders.

Any failed check raises, so the script exits non-zero; the last line of a
passing run is one JSON object naming the device. Nothing is written
outside the checkout: JAX's compile cache goes to
``JAX_COMPILATION_CACHE_DIR`` when set, else to ``.jax_cache/`` here.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
KS_W, KS_H, KS_SPP = 400, 266, 8
GRAD_W, GRAD_H = 320, 180
SEED = 1

# Tolerances, with their reasons:
# - kernel vs walk, per ray: misses and (kind, idx) agree on >= 99.9% of
#   rays (borderline edge hits may resolve differently between the kernel's
#   and the walk's evaluation order); hit t agrees to rtol 1e-4 where both
#   report the same primitive (same formulas, different fusion/rounding).
RAY_AGREE = 0.999
RAY_T_RTOL = 1e-4
# - frames rendered two ways (kernel vs walk, sharded vs one card): same
#   RNG draws per (pixel, sample), so pixels agree except where a
#   borderline hit or scatter decision flips one path: at most 1e-4 of
#   the values differ by more than 1e-3, the frame means agree to 1e-4
#   relative and segment totals to 1e-4 relative.
PIX_ATOL = 1e-3
PIX_FRAC = 1e-4
MEAN_RTOL = 1e-4
SEG_RTOL = 1e-4


def _smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable ({err})"


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _frames_agree(name, a, b, seg_a=None, seg_b=None):
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    _check(a.shape == b.shape, f"{name}: shapes {a.shape} vs {b.shape}")
    _check(np.isfinite(a).all() and np.isfinite(b).all(),
           f"{name}: non-finite pixels")
    frac = float((np.abs(a - b) > PIX_ATOL).mean())
    mean_rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-12)
    line = (f"{name}: values differing > {PIX_ATOL}: {frac:.3g} "
            f"(limit {PIX_FRAC}), mean rel diff {mean_rel:.3g} "
            f"(limit {MEAN_RTOL})")
    if seg_a is not None:
        seg_rel = abs(float(seg_a) - float(seg_b)) / float(seg_b)
        line += (f", segments {float(seg_a):.0f} vs {float(seg_b):.0f} "
                 f"(rel {seg_rel:.3g}, limit {SEG_RTOL})")
        _check(seg_rel <= SEG_RTOL, f"{name}: segment counts differ")
    print(line, flush=True)
    _check(frac <= PIX_FRAC, f"{name}: too many differing pixels")
    _check(mean_rel <= MEAN_RTOL, f"{name}: frame means differ")


def _sponza(spp):
    from scenes import create_sponza_class_scene
    from solstrale import OnlyFinal, RenderConfig

    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp, seed=SEED,
                       render_image_strategy=OnlyFinal())
    return create_sponza_class_scene(cfg)


def phase_traversal(cs):
    """(b) kernel vs XLA walk on 131,072 primary and secondary rays."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from solstrale.accel import bvh_closest_hit
    from solstrale.geo import INF, RAY_T_MIN
    from solstrale.ops.traverse import bvh_closest_hit_kernel
    from solstrale.renderer import integrator

    r = 131072
    rng = np.random.default_rng(0)
    pix = jnp.asarray(rng.integers(0, W * H, r).astype(np.int32))
    _, o, d = integrator.camera_rays(cs, pix, W, H, jnp.int32(1),
                                     jnp.int32(SEED))
    o, d = jnp.stack(o, -1), jnp.stack(d, -1)
    kern = jax.jit(lambda o, d: bvh_closest_hit_kernel(
        cs.kbvh, cs.solids, o, d, RAY_T_MIN))
    walk = jax.jit(lambda o, d: bvh_closest_hit(
        cs.bvh, cs.solids, o, d, RAY_T_MIN, INF))
    prim = jax.block_until_ready(walk(o, d))
    t = jnp.where(jnp.isfinite(prim[0]), prim[0], 1.0)
    secondary = (o + d * t[:, None] * 0.999,
                 jnp.asarray(rng.normal(size=(r, 3)).astype(np.float32)))
    times = {}
    for name, (oo, dd) in (("primary", (o, d)), ("secondary", secondary)):
        a = [np.asarray(x) for x in jax.block_until_ready(kern(oo, dd))]
        b = [np.asarray(x) for x in jax.block_until_ready(walk(oo, dd))]
        ha, hb = np.isfinite(a[0]), np.isfinite(b[0])
        same = (a[1] == b[1]) & (a[2] == b[2])
        agree = float(((ha == hb) & (~hb | same)).mean())
        both = ha & hb & same
        rel = (np.abs(a[0][both] - b[0][both])
               / np.maximum(np.abs(b[0][both]), 1e-6))
        max_rel = float(rel.max()) if rel.size else 0.0
        ts = {"kernel": [], "walk": []}
        for which in ("kernel", "walk", "walk", "kernel") * 2:
            f = kern if which == "kernel" else walk
            ts[which].append(_timed(f, oo, dd)[1])
        med = {k: float(np.median(v)) * 1e3 for k, v in ts.items()}
        times[name] = med
        print(f"(b) {name} rays={r}: hits={int(hb.sum())} miss+prim "
              f"agreement {agree:.6f} (limit {RAY_AGREE}), max rel t diff "
              f"{max_rel:.3g} (limit {RAY_T_RTOL}); median time kernel "
              f"{med['kernel']:.3f} ms, XLA walk {med['walk']:.3f} ms",
              flush=True)
        _check(agree >= RAY_AGREE, f"(b) {name}: agreement {agree}")
        _check(max_rel <= RAY_T_RTOL, f"(b) {name}: t differs {max_rel}")
    return times


def phase_frame(scene, cs):
    """(c) ray_trace at 1080p, then the same frame through both paths."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from solstrale import ray_trace
    from solstrale.renderer import integrator

    t0 = time.perf_counter()
    last = None
    for progress in ray_trace(scene):
        last = progress
    img = last.render_image
    segs = float(last.segments)
    wall = time.perf_counter() - t0
    _check(img is not None and img.shape == (H, W, 3), "(c) no image")
    _check(float(img.mean()) > 5.0, f"(c) black frame: mean {img.mean()}")
    print(f"(c) ray_trace {W}x{H} 2 spp depth 50: wall {wall:.3f} s "
          f"(compile included), segments {segs:.0f}, u8 mean "
          f"{float(img.mean()):.3f}", flush=True)

    def frame(c):
        return integrator.render_sample_batch(
            c, jnp.int32(1), jnp.int32(SEED), width=W, height=H,
            max_depth=50, shader_kind=integrator.SHADER_PATH,
            need_aux=False, n_samples=2)

    out = {}
    for name, c in (("kernel", cs), ("walk", dataclasses.replace(
            cs, kbvh=None))):
        frame(c)[0].block_until_ready()
        res, dt = _timed(frame, c)
        out[name] = (np.asarray(res[0]), float(res[3]), dt)
        print(f"(c) render_sample_batch via {name}: {dt:.4f} s, segments "
              f"{float(res[3]):.0f}, {float(res[3]) / dt / 1e6:.3f} "
              f"Mrays/s", flush=True)
    _frames_agree("(c) kernel vs walk frame", out["kernel"][0],
                  out["walk"][0], out["kernel"][1], out["walk"][1])
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"(c) peak_bytes_in_use {peak}", flush=True)
    return out


def phase_kitchen_sink():
    """(d) BVH-free scene with a medium and every material kind."""
    import jax.numpy as jnp
    import numpy as np

    from scenes import create_mini_kitchen_sink, create_test_scene
    from solstrale import RenderConfig
    from solstrale.renderer import integrator
    from solstrale.scene.compile import compile_scene

    w, h, spp = KS_W, KS_H, KS_SPP
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp, seed=SEED)
    kw = dict(width=w, height=h, max_depth=50,
              shader_kind=integrator.SHADER_PATH, need_aux=False)
    res = {}
    for name, make in (("mini kitchen-sink", create_mini_kitchen_sink),
                       ("kitchen-sink", create_test_scene)):
        cs = compile_scene(make(cfg))
        _check(cs.bvh is None and (len(cs.media) == 1),
               f"(d) {name} must be BVH-free with one medium")

        def batch(n):
            return integrator.render_sample_batch(
                cs, jnp.int32(1), jnp.int32(SEED), n_samples=n, **kw)

        batch(spp)[0].block_until_ready()
        out, dt = _timed(batch, spp)
        img = np.asarray(out[0])
        _check(np.isfinite(img).all() and img.mean() > 1e-3,
               f"(d) {name}: non-finite or black")
        print(f"(d) {name} {w}x{h} @ {spp} spp: {dt:.4f} s, segments "
              f"{float(out[3]):.0f}, {float(out[3]) / dt / 1e6:.3f} "
              f"Mrays/s", flush=True)
        res[name] = (float(out[3]), dt)
        if name == "kitchen-sink":
            _time_sweep(cs, w, h)
        if name == "mini kitchen-sink":
            # reference: the per-sample full-image wavefront (trace)
            two = batch(2)
            ref = sum(np.asarray(integrator.render_sample(
                cs, jnp.int32(s), jnp.int32(SEED), **kw)[0])
                for s in (1, 2))
            _frames_agree("(d) work queue vs per-sample wavefront",
                          two[0], ref)
    return res


def _time_sweep(cs, w, h):
    """Time of the brute-force XLA sweep (solids + medium events) alone on
    one wavefront of camera rays, the work scene_hit does per iteration."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from solstrale.renderer import integrator

    r = 65536
    pix = jnp.arange(r, dtype=jnp.int32) % (w * h)
    _, o, d = integrator.camera_rays(cs, pix, w, h, jnp.int32(1),
                                     jnp.int32(SEED))
    zero = jnp.zeros((r,), jnp.int32)
    hit = jax.jit(lambda o, d: integrator.scene_hit(
        cs, o, d, pix, zero, zero, jnp.int32(SEED)))
    jax.block_until_ready(hit(o, d))
    ms = float(np.median([_timed(hit, o, d)[1] for _ in range(7)])) * 1e3
    print(f"(d) kitchen-sink XLA sweep (scene_hit, {r} rays): median "
          f"{ms:.3f} ms", flush=True)


def phase_gradients():
    """(e) three SGD steps on the texture arena of a BVH fixture."""
    import jax.numpy as jnp
    import numpy as np

    from scenes import create_sponza_class_scene
    from solstrale import RenderConfig
    from solstrale.diff import (image_and_texture_grad, render_linear,
                                set_texture_params)
    from solstrale.scene.compile import compile_scene

    w, h, depth = GRAD_W, GRAD_H, 8
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=1, seed=SEED)
    cs = compile_scene(create_sponza_class_scene(cfg, n_cells=64))
    _check(cs.kbvh is not None, "(e) fixture must take the BVH path")
    target = render_linear(cs, width=w, height=h, max_depth=depth,
                           n_samples=1, seed=SEED)
    rng = np.random.default_rng(3)
    px = np.asarray(cs.textures.pixels)
    params = jnp.asarray(np.clip(px + rng.normal(0, 0.2, px.shape), 0, 1),
                         jnp.float32)
    losses = []
    for step in range(3):
        t0 = time.perf_counter()
        loss, grad = image_and_texture_grad(
            set_texture_params(cs, params), target, width=w, height=h,
            max_depth=depth, n_samples=1, seed=SEED)
        g = np.asarray(grad)
        dt = time.perf_counter() - t0
        _check(np.isfinite(float(loss)), f"(e) step {step}: loss {loss}")
        _check(np.isfinite(g).all(), f"(e) step {step}: non-finite grad")
        _check(np.abs(g).max() > 0, f"(e) step {step}: zero gradient")
        losses.append(float(loss))
        print(f"(e) step {step}: loss {float(loss):.6g}, |grad|max "
              f"{np.abs(g).max():.3g}, {dt:.3f} s", flush=True)
        params = params - 50.0 * grad
    return losses


def phase_determinism(cs):
    """(f) two same-seed renders of the 1080p frame and of a small
    frame with many samples per pixel in flight."""
    import jax.numpy as jnp
    import numpy as np

    from scenes import create_mini_kitchen_sink
    from solstrale import RenderConfig
    from solstrale.renderer import integrator
    from solstrale.scene.compile import compile_scene

    small = RenderConfig(width=KS_W, height=KS_H,
                         samples_per_pixel=KS_SPP, seed=SEED)
    cases = (("sponza 1080p 2 spp", cs, W, H, 2),
             ("mini kitchen-sink 8 spp", compile_scene(
                 create_mini_kitchen_sink(small)), KS_W, KS_H, KS_SPP))
    result = {}
    for name, c, w, h, n in cases:
        imgs = [np.asarray(integrator.render_sample_batch(
            c, jnp.int32(1), jnp.int32(SEED), width=w, height=h,
            max_depth=50, shader_kind=integrator.SHADER_PATH,
            need_aux=False, n_samples=n)[0]) for _ in range(2)]
        identical = bool(np.array_equal(imgs[0], imgs[1]))
        diff = float(np.abs(imgs[0] - imgs[1]).max())
        print(f"(f) {name}: bit-identical {identical}, max abs diff "
              f"{diff:.3g}", flush=True)
        _frames_agree(f"(f) {name} rerun", imgs[0], imgs[1])
        result[name] = identical
    return result


def run_one_card():
    import jax

    from solstrale.scene.compile import compile_scene

    scene = _sponza(spp=2)
    t0 = time.perf_counter()
    cs = compile_scene(scene)
    print(f"sponza-class scene: {int(cs.solids.tr_valid.sum())} "
          f"triangles, compile_scene {time.perf_counter() - t0:.3f} s",
          flush=True)
    _check(cs.kbvh is not None, "sponza must carry the kernel layout")
    phase_traversal(cs)
    phase_frame(scene, cs)
    phase_kitchen_sink()
    phase_gradients()
    phase_determinism(cs)
    return jax.devices()


def run_four_cards():
    """render_batch_sharded over a (tile=4, sample=1) mesh at sponza 1080p
    against the one-card render_sample_batch frame."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from solstrale.parallel import (make_mesh, render_batch_sharded,
                                    replicate_scene)
    from solstrale.renderer import integrator
    from solstrale.scene.compile import compile_scene

    devs = jax.devices()
    _check(len(devs) >= 4, f"--four-cards needs 4 GPUs, found {len(devs)}")
    cs = compile_scene(_sponza(spp=1))
    mesh = make_mesh(n_tile=4, n_sample=1, devices=devs[:4])
    cs_r = replicate_scene(cs, mesh)

    def sharded():
        return render_batch_sharded(cs_r, 1, 1, SEED, mesh, width=W,
                                    height=H, max_depth=50, shard_stats=True)

    def one():
        return integrator.render_sample_batch(
            cs, jnp.int32(1), jnp.int32(SEED), width=W, height=H,
            max_depth=50, shader_kind=integrator.SHADER_PATH,
            need_aux=False, n_samples=1)

    sharded()[0].block_until_ready()
    one()[0].block_until_ready()
    # alternated, warm; median of each
    times = {sharded: [], one: []}
    results = {}
    for fn in (sharded, one, one, sharded) * 2:
        results[fn], dt = _timed(fn)
        times[fn].append(dt)
    dt4 = float(np.median(times[sharded]))
    dt1 = float(np.median(times[one]))
    img4, segs4, per_tile = results[sharded]
    res1 = results[one]
    print(f"4 cards: {dt4:.4f} s, segments {float(segs4):.0f}, "
          f"{float(segs4) / dt4 / 1e6:.3f} Mrays/s; per-shard segments "
          f"{np.asarray(per_tile).astype(int).tolist()}", flush=True)
    print(f"1 card: {dt1:.4f} s, segments {float(res1[3]):.0f}, "
          f"{float(res1[3]) / dt1 / 1e6:.3f} Mrays/s", flush=True)
    _frames_agree("4-card vs 1-card frame", img4, res1[0], segs4, res1[3])
    return devs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card sharded render phase")
    args = parser.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    print(f"(a) {_smi()}", flush=True)
    print(f"(a) jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}",
          flush=True)

    for p in (ROOT, os.path.join(ROOT, "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from solstrale.utils import use_compile_cache

    use_compile_cache(os.path.join(ROOT, ".jax_cache"))
    devs = run_four_cards() if args.four_cards else run_one_card()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
