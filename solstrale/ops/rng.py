"""Counter-based stateless RNG for the wavefront path tracer.

The reference uses a thread-local mutable PRNG with no seed control
(``/root/reference/src/random.rs``), which makes renders unreproducible. The
design here replaces it with a *pure counter-based hash*: every random
draw is a function of ``(pixel_id, sample, bounce, purpose, seed)``. This gives

- reproducible images for a fixed seed (bitwise on the CPU; on the GPU
  the image accumulator's atomic scatter-add can reorder sums when several
  samples of one pixel finish together),
- identical results under ANY sharding (values depend only on logical pixel
  position, never on tile shape or device count),
- exact RNG replay for path-replay differentiation (same counters → same path).

Hash: PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering", JCGT 2020).
Pure uint32 arithmetic — runs on VPU lanes, works inside Pallas kernels.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Purpose tags: draw-site identifiers so each random decision at a given
# (pixel, sample, bounce) consumes an independent counter stream.
P_JITTER = 0        # pixel-position jitter (renderer/mod.rs:263-264)
P_LENS = 1          # defocus disc sample (camera.rs:77-83)
P_MIX_COIN = 2      # 50/50 mixture pdf coin (pdf.rs:42-48)
P_LIGHT_PICK = 3    # uniform light index (pdf.rs:98-101)
P_LIGHT_SAMPLE = 4  # point-on-light sample (quad.rs:145-148, sphere.rs:142-153)
P_COSINE = 5        # cosine-hemisphere sample (vec3.rs:417-428)
P_DIELECTRIC = 6    # Schlick reflect/refract coin (material/mod.rs:292)
P_FUZZ = 7          # metal fuzz sphere sample (material/mod.rs:246)
P_MEDIUM = 8        # free-flight exponential sample (constant_medium.rs:55)
P_BLEND_SCATTER = 9   # blend material pick for scatter (material/mod.rs:431)
P_BLEND_NORMAL = 10   # blend material pick for normal map (material/mod.rs:439)
P_PHASE = 11        # isotropic medium random normal (constant_medium.rs:68)

_U32 = jnp.uint32


def _pcg4d(a, b, c, d):
    """PCG4D mixing on four uint32 lanes; returns four decorrelated uint32."""
    a = a * _U32(1664525) + _U32(1013904223)
    b = b * _U32(1664525) + _U32(1013904223)
    c = c * _U32(1664525) + _U32(1013904223)
    d = d * _U32(1664525) + _U32(1013904223)
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    return a, b, c, d


def _to_unit_float(u):
    """uint32 → float32 in [0, 1) using the top 24 bits."""
    return (u >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


@partial(jax.jit, static_argnames=("purpose",), inline=True)
def uniform4(pixel_id, sample, bounce, purpose, seed):
    """Four independent uniforms in [0,1) per counter tuple.

    pixel_id / sample / bounce may be arrays (broadcastable); purpose is a
    static Python int; seed is a traced scalar.
    """
    a = jnp.asarray(pixel_id).astype(_U32)
    b = jnp.asarray(sample).astype(_U32)
    c = (jnp.asarray(bounce).astype(_U32) << 8) | _U32(purpose)
    d = jnp.asarray(seed).astype(_U32)
    a, b, c, d = jnp.broadcast_arrays(a, b, c, d)
    x, y, z, w = _pcg4d(a, b, c, d)
    return (_to_unit_float(x), _to_unit_float(y),
            _to_unit_float(z), _to_unit_float(w))


def uniform(pixel_id, sample, bounce, purpose, seed):
    """Single uniform in [0,1)."""
    return uniform4(pixel_id, sample, bounce, purpose, seed)[0]


# --- distribution samplers (branch-free; distributions match the reference,
# --- which itself has no deterministic stream to reproduce) ---------------

def cosine_direction(r1, r2):
    """Cosine-weighted hemisphere direction in local (t, b, n) coordinates
    (vec3.rs:417-428) — exact same mapping as the reference."""
    phi = 2.0 * jnp.pi * r1
    r2_sqrt = jnp.sqrt(r2)
    x = jnp.cos(phi) * r2_sqrt
    y = jnp.sin(phi) * r2_sqrt
    z = jnp.sqrt(1.0 - r2)
    return jnp.stack([x, y, z], axis=-1)


def unit_vector(r1, r2):
    """Uniform direction on the unit sphere. The reference rejection-samples
    (vec3.rs:395-397); we invert the CDF directly — identical distribution,
    no data-dependent loop."""
    z = 1.0 - 2.0 * r1
    phi = 2.0 * jnp.pi * r2
    zz = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([jnp.cos(phi) * zz, jnp.sin(phi) * zz, z], axis=-1)


def in_unit_sphere(r1, r2, r3):
    """Uniform point inside the unit ball (vec3.rs:380-392 rejection loop
    replaced by radius-CDF inversion); cbrt written as exp(log/3)."""
    d = unit_vector(r1, r2)
    radius = jnp.exp(jnp.log(jnp.maximum(r3, 1e-12)) / 3.0)
    return d * radius[..., None]


def in_unit_disc(r1, r2):
    """Uniform point in the unit disc, z = 0 (vec3.rs:400-412)."""
    r = jnp.sqrt(r1)
    phi = 2.0 * jnp.pi * r2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi),
                      jnp.zeros_like(r)], axis=-1)


def to_sphere(radius, distance_squared, r1, r2):
    """Cone sample towards a sphere light of `radius` at squared distance
    `distance_squared` — local z-up coordinates (sphere.rs:142-153)."""
    z = 1.0 + r2 * (jnp.sqrt(jnp.maximum(0.0, 1.0 - radius * radius / distance_squared)) - 1.0)
    phi = 2.0 * jnp.pi * r1
    zz = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([jnp.cos(phi) * zz, jnp.sin(phi) * zz, z], axis=-1)


# --- SoA variants (component tuples, full-lane (R,) ops; see geo/soa.py) ---

def cosine_direction3(r1, r2):
    """SoA cosine_direction (vec3.rs:417-428)."""
    z = jnp.sqrt(1.0 - r2)
    phi = 2.0 * jnp.pi * r1
    sq_r2 = jnp.sqrt(r2)
    return (jnp.cos(phi) * sq_r2, jnp.sin(phi) * sq_r2, z)


def unit_vector3(r1, r2):
    """SoA unit_vector: uniform direction on the unit sphere."""
    z = 1.0 - 2.0 * r1
    phi = 2.0 * jnp.pi * r2
    zz = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return (jnp.cos(phi) * zz, jnp.sin(phi) * zz, z)


def in_unit_sphere3(r1, r2, r3):
    """SoA in_unit_sphere (radius-CDF inversion, exp(log/3) cbrt)."""
    d = unit_vector3(r1, r2)
    radius = jnp.exp(jnp.log(jnp.maximum(r3, 1e-12)) / 3.0)
    return (d[0] * radius, d[1] * radius, d[2] * radius)


def in_unit_disc3(r1, r2):
    """SoA in_unit_disc (z = 0)."""
    r = jnp.sqrt(r1)
    phi = 2.0 * jnp.pi * r2
    return (r * jnp.cos(phi), r * jnp.sin(phi), jnp.zeros_like(r))


def to_sphere3(radius, distance_squared, r1, r2):
    """SoA cone sample towards a sphere light (sphere.rs:142-153)."""
    z = 1.0 + r2 * (jnp.sqrt(jnp.maximum(
        0.0, 1.0 - radius * radius / distance_squared)) - 1.0)
    phi = 2.0 * jnp.pi * r1
    zz = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return (jnp.cos(phi) * zz, jnp.sin(phi) * zz, z)
