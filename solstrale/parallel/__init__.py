"""Device-mesh sharding for multi-chip / multi-host rendering and training.

Data-parallel replacement for the reference's entire concurrency stack (rayon
row tasks + Arc<Mutex> accumulators + mpsc channels,
renderer/mod.rs:232-291): a ``jax.sharding.Mesh`` with named axes, the image
sharded as pixel tiles via ``shard_map``, the scene replicated per device,
and gradient ``psum`` across the mesh for inverse rendering. Because the RNG
is counter-based on pixel ids (ops/rng.py), any partition renders
bit-identically to the single-device path — the lock-free analogue of the
reference's row merging.

Axes:
- ``tile``: pixels partitioned into contiguous tiles (data parallel over the
  image).
- ``sample``: independent sample batches (Monte Carlo parallelism); combined
  with a psum at emission time.
"""
from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..renderer import integrator


def make_mesh(n_tile=None, n_sample=1, devices=None):
    """Build a (tile, sample) mesh over available devices."""
    devices = devices if devices is not None else jax.devices()
    n_dev = len(devices)
    if n_tile is None:
        n_tile = n_dev // n_sample
    assert n_tile * n_sample == n_dev, (n_tile, n_sample, n_dev)
    dev_array = np.array(devices).reshape(n_tile, n_sample)
    return Mesh(dev_array, ("tile", "sample"))


def _pad_to(n, m):
    return (n + m - 1) // m * m


@functools.lru_cache(maxsize=None)
def _sample_shard_fn(mesh, width, height, max_depth, shader_kind, need_aux):
    """The jitted shard_map program of render_sample_sharded, built once per
    (mesh, static config) so repeated calls reuse its compilation. jit so
    the shard_map (and any remat closed_call inside) compiles as one
    program instead of eager per-device dispatch."""

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P("tile"), P("sample"), P(), P()),
             out_specs=(P("tile"), P("tile"), P("tile")))
    def shard_fn(cs_rep, pix_shard, sample_off, sample_base, seed_):
        color, albedo, normal = integrator.render_pixels(
            cs_rep, pix_shard, sample_base + sample_off[0], seed_,
            width=width, height=height, max_depth=max_depth,
            shader_kind=shader_kind, need_aux=need_aux)
        # accumulate over the sample axis (progressive sum semantics)
        color = jax.lax.psum(color, "sample")
        albedo = jax.lax.psum(albedo, "sample")
        normal = jax.lax.psum(normal, "sample")
        return color, albedo, normal

    return shard_fn


@functools.lru_cache(maxsize=None)
def _batch_shard_fn(mesh, width, height, max_depth, per_shard):
    """The jitted shard_map program of render_batch_sharded, built once per
    (mesh, static config): a new jit object per call would trace and
    compile the whole integrator again on every progressive batch."""

    # check_vma=False: trace_queued's zero-initialized while_loop carries
    # are unvarying; the collective-safety check would demand pvary noise
    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P("tile"), P("tile"), P("sample"), P(), P()),
             out_specs=(P("tile"), P(), P("tile")), check_vma=False)
    def shard_fn(cs_rep, pix_shard, n_valid, sample_off, sample_base, seed_):
        accum, segs = integrator.trace_queued(
            cs_rep, pix_shard, sample_base + sample_off[0], per_shard,
            seed_, width=width, height=height, max_depth=max_depth,
            n_valid=n_valid[0])
        accum = jax.lax.psum(accum, "sample")
        segs_tile = jax.lax.psum(segs, "sample")      # this tile, all samples
        segs_tot = jax.lax.psum(segs_tile, "tile")
        return accum, segs_tot, jnp.reshape(segs_tile, (1,))

    return shard_fn


def render_sample_sharded(cs, sample, seed, mesh, *, width, height, max_depth,
                          shader_kind, need_aux):
    """One full-image sample pass sharded over the mesh.

    Pixels are partitioned across the ``tile`` axis; consecutive samples
    across the ``sample`` axis (each sample-shard renders sample + its index);
    results are psum-reduced over ``sample`` so the output is the *sum* of
    n_sample sample passes, matching the renderer's progressive accumulator.
    Returns (pixel, albedo, normal) image planes (height, width, 3).
    """
    n_tile = mesh.shape["tile"]
    n_sample = mesh.shape["sample"]
    n_pix = width * height
    n_padded = _pad_to(n_pix, n_tile)

    pix = jnp.arange(n_padded, dtype=jnp.int32)
    # clamp padding ids; their results are dropped on reshape
    pix = jnp.minimum(pix, n_pix - 1)
    sample_offsets = jnp.arange(n_sample, dtype=jnp.int32)

    shard_fn = _sample_shard_fn(mesh, width, height, max_depth, shader_kind,
                                need_aux)
    color, albedo, normal = shard_fn(cs, pix, sample_offsets,
                                     jnp.int32(sample), jnp.int32(seed))

    def to_image(c):
        return c[:n_pix].reshape(height, width, 3)[::-1]

    return to_image(color), to_image(albedo), to_image(normal)


def render_batch_sharded(cs, sample_start, n_samples, seed, mesh, *, width,
                         height, max_depth, shard_stats=False):
    """A whole progressive sample batch sharded over the mesh, with each
    tile-shard running the work-queue wavefront (integrator.trace_queued) —
    the ≈100%-occupancy integrator — over its own pixel partition.

    Pixels are partitioned across ``tile``; sample sub-batches across
    ``sample`` (shard k renders samples [start + k·q, start + (k+1)·q) where
    q = n_samples / n_sample_shards); partial sums psum-reduce over
    ``sample``. Counter-based RNG keyed on (pixel, sample) makes every
    partition bit-identical to the single-device render (test_sharding.py).

    Returns (color_image (H, W, 3) summed over n_samples, total segments);
    with shard_stats=True additionally a (n_tile,) per-tile-shard segment
    count (load-balance telemetry: uneven tile difficulty is the analogue
    of the reference's work-stealing row imbalance, renderer/mod.rs:241-248).
    """
    n_tile = mesh.shape["tile"]
    n_sample = mesh.shape["sample"]
    assert n_samples % n_sample == 0, (n_samples, n_sample)
    per_shard = n_samples // n_sample
    n_pix = width * height
    n_padded = _pad_to(n_pix, n_tile)

    # pad with repeats of pixel 0; padded positions are excluded from each
    # shard's queue via n_valid (only the LAST tile shard holds padding), so
    # segment counts stay exact for non-divisible image sizes
    ids = jnp.arange(n_padded, dtype=jnp.int32)
    pix = jnp.where(ids < n_pix, ids, 0)
    per_tile = n_padded // n_tile
    valid_counts = jnp.sum((ids < n_pix).reshape(n_tile, per_tile),
                           axis=1).astype(jnp.int32)
    sample_offsets = jnp.arange(n_sample, dtype=jnp.int32) * per_shard

    shard_fn = _batch_shard_fn(mesh, width, height, max_depth, per_shard)
    accum, segs, segs_per_tile = shard_fn(
        cs, pix, valid_counts, sample_offsets,
        jnp.asarray(sample_start, jnp.int32), jnp.asarray(seed, jnp.int32))
    color = accum[:n_pix].reshape(height, width, 3)[::-1]
    if shard_stats:
        return color, segs, segs_per_tile
    return color, segs


def replicate_scene(cs, mesh):
    """Place the compiled scene replicated on every device (the reference
    replicates the scene per thread implicitly via shared memory; here it is
    replicated per device)."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(cs, sharding)
