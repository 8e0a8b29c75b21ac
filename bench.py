"""Benchmark: path-tracing throughput in Mrays/s (path segments traced per
device-synchronised wall second) on five scenes, on a GPU.

    python bench.py

Cells (fixtures in tests/scenes.py):
- sponza_1080p_mrays_per_s: 262,088-triangle textured sponza-class
  interior, 1920x1080, 1 spp, depth 50 (the headline, printed last);
- sponza_production_mrays_per_s: the same terrain split into 16 materials
  of every kind with 4 emitters, 1920x1080;
- many_lights_mrays_per_s: 64 emitters over a BVH terrain, 960x540;
- kitchen_sink_mrays_per_s: the reference's profiling scene
  (src/bin/profiling.rs:15-21), 400x266 @ 8 spp;
- small_scene_mrays_per_s: its solid-color analogue with every material
  kind and a medium, 400x266 @ 8 spp.

Each cell prints one JSON line naming the device, its power limit and the
device count. A cell that fails prints its error; after all cells the
script exits non-zero if any failed. There is no CPU fallback.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

NORTH_STAR = 100.0  # Mrays/s per card, sponza 1080p (BASELINE.json)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def _measure(cs, width, height, spp, max_depth):
    """Warm once, then time one sample batch to block_until_ready."""
    from solstrale.renderer import integrator

    def run(sample_start):
        return integrator.render_sample_batch(
            cs, sample_start, jnp.int32(1), width=width, height=height,
            max_depth=max_depth, shader_kind=integrator.SHADER_PATH,
            need_aux=False, n_samples=spp)

    jax.block_until_ready(run(jnp.int32(100)))
    t0 = time.perf_counter()
    color, _, _, segs = jax.block_until_ready(run(jnp.int32(1)))
    dt = time.perf_counter() - t0
    # a black frame means the workload degenerated (e.g. camera facing an
    # unlit backface): refuse to report a throughput for it
    checksum = float(jnp.sum(color))
    if not checksum > 0:
        raise RuntimeError(f"degenerate render: checksum={checksum}")
    return float(segs) / dt / 1e6, float(segs), dt


def _cell(make_scene, width, height, spp, **scene_kw):
    from solstrale import RenderConfig
    from solstrale.scene.compile import compile_scene

    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       seed=1)
    cs = compile_scene(make_scene(cfg, **scene_kw))
    return _measure(cs, width, height, spp, 50)


def _cells():
    import scenes

    return (
        ("kitchen_sink_mrays_per_s",
         lambda: _cell(scenes.create_test_scene, 400, 266, 8)),
        ("small_scene_mrays_per_s",
         lambda: _cell(scenes.create_mini_kitchen_sink, 400, 266, 8)),
        ("sponza_production_mrays_per_s",
         lambda: _cell(scenes.create_sponza_production_scene, 1920, 1080,
                       1)),
        ("many_lights_mrays_per_s",
         lambda: _cell(scenes.create_many_light_scene, 960, 540, 1,
                       n_lights=64)),
        # headline last
        ("sponza_1080p_mrays_per_s",
         lambda: _cell(scenes.create_sponza_class_scene, 1920, 1080, 1)),
    )


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    from solstrale.utils import use_compile_cache

    use_compile_cache(os.path.join(ROOT, ".jax_cache"))
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "power_limit": _power_limit()}
    failed = []
    for name, fn in _cells():
        line = {"metric": name, "device": device}
        try:
            mrays, segs, dt = fn()
            line.update(value=mrays, unit="Mrays/s", segments=segs,
                        seconds=dt, vs_north_star=mrays / NORTH_STAR)
        except Exception as err:  # noqa: BLE001 — report, then fail below
            failed.append(name)
            line["error"] = f"{type(err).__name__}: {err}"[:500]
        print(json.dumps(line), flush=True)
    if failed:
        print(f"bench: failed cells: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
