"""Structure-of-arrays vec3 math: a vector batch is a tuple of three (R,)
float32 arrays.

Why this exists: elementwise math on ``(R, 3)`` arrays works on a narrow
trailing dimension of 3 (strided access, poor vectorisation), while the same
chain on (R,) components is fully contiguous. The integrator's shading path
(ONBs, reflections, light pdfs) is pure elementwise vec3 math, so it runs on
this SoA form; ``(R, 3)`` arrays appear only at module boundaries (kernel
inputs, images).

Semantics mirror geo/__init__ (and the reference's vec3.rs) op for op, with
identical association order, so results are bitwise-equal to the AoS forms.
"""
from __future__ import annotations

import jax.numpy as jnp


def from_aos(a):
    """(R, 3) -> ((R,), (R,), (R,)). Boundary conversion — avoid in loops."""
    return (a[..., 0], a[..., 1], a[..., 2])


def to_aos(v):
    """((R,),)*3 -> (R, 3). Boundary conversion — avoid in loops."""
    return jnp.stack(v, axis=-1)


def splat(x, y, z, like=None):
    """Constant vector, optionally broadcast to match ``like[0]``."""
    if like is None:
        return (jnp.float32(x), jnp.float32(y), jnp.float32(z))
    o = jnp.zeros_like(like[0])
    return (o + x, o + y, o + z)


def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vmul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vneg(a):
    return (-a[0], -a[1], -a[2])


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def length_squared3(a):
    return dot3(a, a)


def length3(a):
    return jnp.sqrt(length_squared3(a))


def unit3(a):
    inv = 1.0 / length3(a)
    return vscale(a, inv)


def where3(m, a, b):
    return (jnp.where(m, a[0], b[0]), jnp.where(m, a[1], b[1]),
            jnp.where(m, a[2], b[2]))


def reflect3(v, n):
    """Mirror reflection about normal n (vec3.rs:333-335)."""
    k = 2.0 * dot3(v, n)
    return (v[0] - n[0] * k, v[1] - n[1] * k, v[2] - n[2] * k)


def refract3(v, n, ir):
    """Snell refraction; v unit, n unit normal, ir ratio (vec3.rs:345-350)."""
    cos_theta = jnp.minimum(dot3(vneg(v), n), 1.0)
    perp = vscale(vadd(vscale(n, cos_theta), v), ir)
    par_k = -jnp.sqrt(jnp.abs(1.0 - length_squared3(perp)))
    return vadd(perp, vscale(n, par_k))


def onb_from_w3(w):
    """Orthonormal basis from a direction (geo/mod.rs:245-258): returns
    (tangent, bi_tangent, normal) with normal = unit(w)."""
    uw = unit3(w)
    pick = jnp.abs(uw[0]) > 0.9
    ax = jnp.where(pick, 0.0, 1.0)
    ay = jnp.where(pick, 1.0, 0.0)
    a = (ax, ay, jnp.zeros_like(ax))
    v = unit3(cross3(uw, a))
    u = cross3(uw, v)
    return u, v, uw


def onb_local3(t, b, n, v):
    """Express local-frame v in world space (geo/mod.rs:260-263)."""
    return (t[0] * v[0] + b[0] * v[1] + n[0] * v[2],
            t[1] * v[0] + b[1] * v[1] + n[1] * v[2],
            t[2] * v[0] + b[2] * v[1] + n[2] * v[2])
