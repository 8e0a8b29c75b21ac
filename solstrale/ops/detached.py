"""Detached-geometry ``custom_vjp`` for the intersection kernel.

``jax.grad`` cannot trace through a ``pallas_call`` (no AD rule), so on the
GPU — where ``scene_hit`` routes BVH scenes through the traversal kernel
(ops/traverse.py) — the production forward would be non-differentiable. This module gives every
kernel entry point an explicit VJP: the forward runs the kernel unchanged
and the backward returns ZERO cotangents for all inputs.

That zero is not an approximation for the parameters the framework
differentiates. The renderer's estimator is *detached-sampling* (see the
``stop_gradient`` on sample directions / pdf weights in
``renderer/integrator.py:scatter``): gradients flow through material
albedos, texture arena values, emitter radiance and the background — none
of which the intersection outputs ``(t, kind, idx)`` depend on. So the
kernel VJP is exactly zero for those parameters, and the kernel path yields
the same gradients as the differentiable XLA path. What IS dropped, in
both paths by design, is geometry derivatives (∂t/∂vertices) — the
detached-geometry choice (boundary/silhouette terms need a dedicated
edge-sampling estimator, out of scope like in the reference, which has no
gradients at all: there is no counterpart to cite).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _zero_cot(x):
    """Zero cotangent for one primal leaf: zeros for inexact dtypes,
    float0 (the JAX unit type for non-differentiable values) otherwise."""
    aval = jax.core.get_aval(x)
    if jnp.issubdtype(aval.dtype, jnp.inexact):
        return jnp.zeros(aval.shape, aval.dtype)
    return np.zeros(aval.shape, jax.dtypes.float0)


@functools.lru_cache(maxsize=None)
def _detached(fn, static_items):
    kwargs = dict(static_items)

    @jax.custom_vjp
    def run(args):
        return fn(*args, **kwargs)

    def fwd(args):
        return fn(*args, **kwargs), args

    def bwd(args, _g):
        return (jax.tree.map(_zero_cot, args),)

    run.defvjp(fwd, bwd)
    return run


def detached_call(fn, *args, **static_kwargs):
    """Call ``fn(*args, **static_kwargs)`` under a zero-backward
    ``custom_vjp``. ``args`` may be arbitrary pytrees (SoA tuples, compiled
    scene tables); ``static_kwargs`` must be hashable and are baked into the
    cached wrapper."""
    return _detached(fn, tuple(sorted(static_kwargs.items())))(args)
