"""Multi-host orchestration.

The reference's concurrency ends at one box (rayon + channels); this module
is the multi-host story: a `jax.distributed` process group, a global
(host, device) mesh whose `tile` axis spans each host's devices and then
the hosts, scene replicated per host, gradients
psum-reduced mesh-wide (overlapped with the backward replay by XLA's
latency-hiding scheduler), and host 0 assembling progressive output.

Run the same script on every host:

    python -m solstrale.parallel.distributed --coordinator host0:1234 \
        --num-hosts 4 --host-id $ID
"""
from __future__ import annotations

import numpy as np


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Bring up the jax.distributed runtime (no-op on a single host)."""
    import jax

    if coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return jax.process_count(), jax.process_index()


def global_mesh(n_sample=1):
    """Mesh over ALL devices in the slice: tile-major so neighboring image
    tiles sit on ICI neighbors within a host."""
    import jax

    from . import make_mesh

    return make_mesh(n_tile=len(jax.devices()) // n_sample,
                     n_sample=n_sample)


def render_distributed(scene, n_sample_axis=1, abort=None):
    """Progressive multi-host render: every host computes its tile shard;
    host 0 receives the assembled image per progress step.

    Yields (progress, image-or-None) on host 0; (progress, None) elsewhere.
    """
    import jax
    import jax.numpy as jnp

    from ..scene.compile import compile_scene
    from ..utils import to_rgb_u8
    from . import render_sample_sharded, replicate_scene

    cfg = scene.render_config
    mesh = global_mesh(n_sample_axis)
    cs = replicate_scene(compile_scene(scene), mesh)

    w, h, spp = cfg.width, cfg.height, cfg.samples_per_pixel
    pixel_sums = jnp.zeros((h, w, 3), jnp.float32)
    sample = 0
    while sample < spp:
        if abort is not None and abort():
            return
        batch = min(n_sample_axis, spp - sample)
        color, _, _ = render_sample_sharded(
            cs, sample + 1, cfg.seed, mesh, width=w, height=h,
            max_depth=cfg.shader.max_depth, shader_kind=cfg.shader.kind,
            need_aux=False)
        pixel_sums = pixel_sums + color
        sample += n_sample_axis
        image = None
        if jax.process_index() == 0:
            image = np.asarray(to_rgb_u8(
                jax.device_get(pixel_sums), min(sample, spp)))
        yield (min(sample, spp) / spp, image)


def scaling_efficiency(rays_per_s_by_hosts):
    """Scaling efficiency vs the 1-host baseline (north-star metric:
    >= 85% from 1 to 4 hosts)."""
    base = rays_per_s_by_hosts[1]
    return {n: r / (n * base) for n, r in rays_per_s_by_hosts.items()}


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-hosts", type=int, default=None)
    p.add_argument("--host-id", type=int, default=None)
    args = p.parse_args()
    n, i = initialize(args.coordinator, args.num_hosts, args.host_id)
    print(f"distributed runtime up: {n} processes, this is {i}")
