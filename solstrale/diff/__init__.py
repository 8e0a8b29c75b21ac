"""Differentiable rendering: gradients of the image w.r.t. scene parameters.

The reference has no differentiability at all; this module is the new
capability the JAX design unlocks. The integrator's bounce loop is a
``lax.scan`` with a per-bounce tape, so reverse-mode AD runs as a *path
replay*: XLA re-walks the recorded wavefront backwards, with sampling
decisions detached (see the stop_gradients in renderer/integrator.py) —
gradients flow through BSDF albedos, texture maps, emitter radiance and the
background, exactly the detached-sampling estimator.

Because the RNG is counter-based, finite differences with a fixed seed probe
the *same* path set, so autodiff must (and does) agree with FD to first
order for parameters that do not change any sampling decision (albedo,
emission — verified in tests/test_gradients.py).
"""
from __future__ import annotations

import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp

from ..renderer import integrator
from ..scene.compile import CompiledScene


def set_texture_params(cs: CompiledScene, params) -> CompiledScene:
    """Swap the texture arena pixels (the differentiable parameter bank)."""
    return dataclasses.replace(
        cs, textures=dataclasses.replace(cs.textures, pixels=params))


def render_linear(cs: CompiledScene, *, width, height, max_depth, n_samples,
                  seed, sample_start=1):
    """Differentiable expected-radiance image: mean of n_samples sample
    passes, linear color, shape (height*width, 3)."""
    pix = jnp.arange(width * height, dtype=jnp.int32)

    def one(sample_off):
        color, _, _ = integrator.render_pixels(
            cs, pix, sample_start + sample_off, jnp.int32(seed),
            width=width, height=height, max_depth=max_depth,
            shader_kind=integrator.SHADER_PATH, need_aux=False,
            early_exit=False)
        return color

    colors = jax.lax.map(one, jnp.arange(n_samples, dtype=jnp.int32))
    return jnp.mean(colors, axis=0)


@partial(jax.jit, static_argnames=("width", "height", "max_depth",
                                   "n_samples"))
def image_and_texture_grad(cs: CompiledScene, target, *, width, height,
                           max_depth, n_samples, seed):
    """L2 loss against a target image and its gradient w.r.t. the texture
    arena — the core inverse-rendering step."""

    def loss_fn(params):
        img = render_linear(set_texture_params(cs, params), width=width,
                            height=height, max_depth=max_depth,
                            n_samples=n_samples, seed=seed)
        return jnp.mean((img - target.reshape(-1, 3)) ** 2)

    loss, grad = jax.value_and_grad(loss_fn)(cs.textures.pixels)
    return loss, grad


@functools.lru_cache(maxsize=None)
def _train_step_fn(mesh, width, height, max_depth, lr, seed):
    """The jitted shard_map step of train_step_sharded, built once per
    (mesh, static config) so a training loop compiles it once. The
    shard_map MUST run under jit — the remat'd bounce scan in
    integrator.trace is a closed_call that eager shard_map cannot
    evaluate."""
    from jax.sharding import PartitionSpec as P

    n_pix = width * height

    # check_vma=False: pallas_call outputs carry no varying-mesh-axes
    # annotation (the traversal kernel runs inside each shard)
    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P("tile"), P("tile"), P("tile"), P("sample")),
             out_specs=(P(), P()), check_vma=False)
    def step(cs_rep, pix_shard, tgt_shard, valid, sample_off):

        def loss_fn(params):
            color, _, _ = integrator.render_pixels(
                set_texture_params(cs_rep, params), pix_shard,
                1 + sample_off[0], jnp.int32(seed),
                width=width, height=height, max_depth=max_depth,
                shader_kind=integrator.SHADER_PATH, need_aux=False,
                early_exit=False)
            err = (color - tgt_shard) ** 2 * valid[:, None]
            return jnp.sum(err)

        loss, grad = jax.value_and_grad(loss_fn)(cs_rep.textures.pixels)
        # all-reduce partial grads/loss over the whole mesh (psum)
        loss = jax.lax.psum(loss, ("tile", "sample"))
        grad = jax.lax.psum(grad, ("tile", "sample"))
        denom = n_pix * 3 * mesh.shape["sample"]
        new_params = cs_rep.textures.pixels - lr * grad / denom
        return loss / denom, new_params

    return step


def train_step_sharded(cs: CompiledScene, target, mesh, *, width, height,
                       max_depth, lr, seed):
    """One sharded inverse-rendering SGD step: tiles across the ``tile``
    axis, sample batches across ``sample``; per-device partial gradients are
    psum-reduced over the whole mesh (overlapped with the backward replay by
    XLA) and applied replicated — the multi-chip training step of
    BASELINE.json config 5."""
    n_tile = mesh.shape["tile"]
    n_pix = width * height
    n_padded = (n_pix + n_tile - 1) // n_tile * n_tile
    ids = jnp.arange(n_padded, dtype=jnp.int32)
    pix_all = jnp.minimum(ids, n_pix - 1)
    valid_all = (ids < n_pix).astype(jnp.float32)
    tgt = target.reshape(-1, 3)
    tgt_padded = jnp.concatenate(
        [tgt, jnp.zeros((n_padded - n_pix, 3), tgt.dtype)], axis=0)
    sample_offsets = jnp.arange(mesh.shape["sample"], dtype=jnp.int32)

    step = _train_step_fn(mesh, width, height, max_depth, float(lr),
                          int(seed))
    loss, new_params = step(cs, pix_all, tgt_padded, valid_all,
                            sample_offsets)
    return loss, set_texture_params(cs, new_params)
