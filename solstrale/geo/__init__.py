"""Vector math core for the path tracer.

Design: vectors are ``(..., 3)`` float32 jnp arrays (SoA-friendly),
all ops are branch-free and vmap/jit/pallas compatible. Semantics mirror the
reference's f64 scalar math (``/root/reference/src/geo/vec3.rs``,
``/root/reference/src/geo/mod.rs``) but are re-designed for 8x128 vector lanes:
no rejection-sampling loops, no pointer structs — pure functions over arrays.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Matches reference ALMOST_ZERO (vec3.rs:21) — used as parallel-ray epsilon in
# quad/triangle intersection. Kept at 1e-8 even in f32: values are compared
# against |denominators| which are O(scene scale).
ALMOST_ZERO = 1e-8

# Global ray interval (interval.rs:25-28): t-min epsilon against
# self-intersection, t-max unbounded.
RAY_T_MIN = 1e-3
INF = jnp.inf


def dot(a, b):
    """Batched dot product over the trailing axis (vec3.rs:256-258)."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    """Batched cross product (vec3.rs:267-273)."""
    return jnp.cross(a, b)


def length_squared(v):
    return jnp.sum(v * v, axis=-1)


def length(v):
    return jnp.sqrt(length_squared(v))


def unit(v):
    """Normalize to length 1 (vec3.rs:309-311)."""
    return v / length(v)[..., None]


def reflect(v, n):
    """Mirror reflection about normal n (vec3.rs:333-335)."""
    return v - n * (2.0 * dot(v, n))[..., None]


def refract(v, n, ir):
    """Snell refraction; v unit, n unit normal, ir refraction ratio
    (vec3.rs:345-350)."""
    cos_theta = jnp.minimum(dot(-v, n), 1.0)
    r_out_perp = (n * cos_theta[..., None] + v) * ir[..., None]
    r_out_par = n * (-jnp.sqrt(jnp.abs(1.0 - length_squared(r_out_perp))))[..., None]
    return r_out_perp + r_out_par


def near_zero(v):
    return jnp.all(jnp.abs(v) < ALMOST_ZERO, axis=-1)


def onb_from_w(w):
    """Orthonormal basis from a single direction (geo/mod.rs:245-258).

    Returns (tangent, bi_tangent, normal) with normal = unit(w).
    """
    unit_w = unit(w)
    pick = jnp.abs(unit_w[..., 0]) > 0.9
    a = jnp.where(
        pick[..., None],
        jnp.asarray([0.0, 1.0, 0.0], unit_w.dtype),
        jnp.asarray([1.0, 0.0, 0.0], unit_w.dtype),
    )
    v = unit(cross(unit_w, a))
    u = cross(unit_w, v)
    return u, v, unit_w


def onb_local(tangent, bi_tangent, normal, a):
    """Express local-space vector a in the (t, b, n) basis
    (geo/mod.rs:261-263)."""
    return (
        tangent * a[..., 0:1]
        + bi_tangent * a[..., 1:2]
        + normal * a[..., 2:3]
    )


def ray_at(origin, direction, t):
    """Position along a ray at parameter t (geo/mod.rs:287-289)."""
    return origin + direction * t[..., None]


def ray_shortest_distance(o1, d1, o2, d2):
    """Shortest distance between two rays (geo/mod.rs:292-304), batched."""
    n = cross(d1, d2)
    od = o1 - o2
    n_len = length(n)
    parallel = n_len == 0.0
    dist_parallel = length(cross(d1, od)) / length(d1)
    dist_skew = dot(od, n) / jnp.where(parallel, 1.0, n_len)
    return jnp.abs(jnp.where(parallel, dist_parallel, dist_skew))


# --- host-side (numpy, f64) construction helpers -------------------------
# Scene baking happens on the host in float64 to mirror the reference's f64
# construction math before casting the compiled SoA tables to f32.

def np_unit(v):
    return v / np.linalg.norm(v)


def np_cross(a, b):
    return np.cross(a, b)


def aabb_from_points(*points):
    """AABB of a point set (geo/mod.rs:88-121). Host-side, f64."""
    pts = np.stack([np.asarray(p, np.float64) for p in points])
    return pts.min(axis=0), pts.max(axis=0)


PAD_DELTA = 1e-4


def pad_aabb_if_needed(lo, hi):
    """Pad degenerate AABB axes (geo/mod.rs:134-156)."""
    lo, hi = np.array(lo, np.float64), np.array(hi, np.float64)
    for ax in range(3):
        if hi[ax] - lo[ax] < PAD_DELTA:
            lo[ax] -= PAD_DELTA / 2
            hi[ax] += PAD_DELTA / 2
    return lo, hi
