"""Per-ray BVH traversal kernel for the GPU (Pallas, Triton route).

The reference walks a pointer-based binary BVH per ray with recursion
(``bvh.rs:165-180``). This kernel keeps that shape — one ray per lane, each
lane walking its own path — over the pointer-free complete tree built by
``accel.build_kernel_bvh`` (node ``j``'s children are ``2j`` and ``2j+1``,
1-based), so a lane needs no stack at all:

- **Bit-trail instead of a stack.** Descending from a node whose two
  children both hit, the lane enters the nearer child and records one "far
  child pending" bit; a single child hit records a 0 bit. To pop, the lane
  jumps up past the trailing zero bits (``j >> ctz(trail)``) and enters the
  sibling (``j ^ 1``). Per-ray state is five registers: node, trail, best
  t, best primitive and a done flag.
- **Both children per step, near first.** Each step at an internal node
  slab-tests both child boxes (adjacent 32-byte rows, one 64-byte read) and
  orders them by entry distance, so the walk finds close hits early and
  prunes with ``t < best`` (the shrinking interval of ``bvh.rs:165-180``).
- **Leaves intersected in place.** A lane at a leaf tests its ``LEAF``
  primitives (one 64-byte row each): triangles with Möller–Trumbore
  (``triangle.rs:119-148``), quads with the plane functional of
  ``quad.rs:150-173`` — the same rules as ``accel._intersect_one``.
- **One launch for the whole wavefront.** Each program walks ``BLOCK`` rays
  until every lane is done; at 262k triangles the nodes (~4 MB) and
  primitive rows (~16 MB) fit in an H100's 50 MB L2.

Spheres are not in the tree (scenes hold a handful); ``closest_hit``
min-combines the kernel's planar result with the XLA sphere sweep.

The kernel has no AD rule: it is wrapped in the zero-cotangent
``custom_vjp`` of ``ops/detached.py`` (intersection outputs carry no
gradient for any differentiated parameter).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..geo import ALMOST_ZERO, INF
from ..scene.compile import KIND_QUAD, KIND_SPHERE, KIND_TRIANGLE

# rays per program: one ray per lane, 4 warps
BLOCK = 128
NUM_WARPS = 4
# primitives per leaf and f32 fields per node / primitive row
LEAF = 4
NODE_F = 8
PRIM_F = 16
# primitive row fields: 0-11 geometry (tri: v0 e1 e2; quad: n d g1 g1o g2
# g2o), 12 kind code (PRIM_TRI / PRIM_QUAD / PRIM_EMPTY)
PRIM_KIND = 12
PRIM_TRI = 1.0
PRIM_QUAD = 0.0
PRIM_EMPTY = -1.0


def hit_path(cs):
    """Which closest-hit implementation a BVH scene takes, decided at
    trace time from the platform the computation is lowered for:

    - ``gpu``: the traversal kernel when the scene carries its layout
      (``cs.kbvh``), otherwise the XLA walk (``accel.bvh_closest_hit``);
    - ``cpu``: the XLA walk;
    - any other platform raises.
    """
    platform = jax.default_backend()
    if platform == "gpu":
        return "kernel" if cs.kbvh is not None else "xla"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no intersection path for platform {platform!r}")


def _slab(nodes_ref, j, o, inv, best_t, mask):
    """Slab test of node row ``j`` (geo/mod.rs:159-188, like
    accel._slab_hit): returns (hit, entry distance)."""
    near = None
    far = None
    for ax in range(3):
        lo = plt.load(nodes_ref.at[j * NODE_F + ax], mask=mask, other=0.0)
        hi = plt.load(nodes_ref.at[j * NODE_F + 3 + ax], mask=mask,
                      other=0.0)
        t0 = (lo - o[ax]) * inv[ax]
        t1 = (hi - o[ax]) * inv[ax]
        n_ax = jnp.minimum(t0, t1)
        f_ax = jnp.maximum(t0, t1)
        near = n_ax if near is None else jnp.maximum(near, n_ax)
        far = f_ax if far is None else jnp.minimum(far, f_ax)
    near = jnp.maximum(near, 0.0)
    return mask & (near < far) & (near <= best_t), near


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _prim_t(prims_ref, row, o, d, tmin, best_t, mask):
    """Intersect primitive ``row`` per lane; returns t (INF on miss)."""
    f = [plt.load(prims_ref.at[row * PRIM_F + k], mask=mask, other=0.0)
         for k in range(PRIM_KIND + 1)]
    kind = f[PRIM_KIND]

    # triangle: Möller–Trumbore on (v0, e1, e2) (triangle.rs:119-148)
    v0, e1, e2 = (f[0], f[1], f[2]), (f[3], f[4], f[5]), (f[6], f[7], f[8])
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv_det = 1.0 / det
    tvec = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    qvec = _cross(tvec, e1)
    bu = _dot(tvec, pvec) * inv_det
    bv = _dot(d, qvec) * inv_det
    tt = _dot(e2, qvec) * inv_det
    ok_t = ((jnp.abs(det) >= ALMOST_ZERO) & (bu >= 0.0) & (bu <= 1.0)
            & (bv >= 0.0) & (bu + bv <= 1.0))

    # quad: plane + planar coordinates (quad.rs:150-173)
    n, dpl = (f[0], f[1], f[2]), f[3]
    g1, g1o = (f[4], f[5], f[6]), f[7]
    g2, g2o = (f[8], f[9], f[10]), f[11]
    dn = _dot(d, n)
    tq = (dpl - _dot(o, n)) / dn
    u = _dot(o, g1) + tq * _dot(d, g1) + g1o
    v = _dot(o, g2) + tq * _dot(d, g2) + g2o
    ok_q = ((jnp.abs(dn) >= ALMOST_ZERO) & (u >= 0.0) & (u <= 1.0)
            & (v >= 0.0) & (v <= 1.0))

    is_tri = kind > 0.5
    t = jnp.where(is_tri, tt, tq)
    ok = (mask & (kind > -0.5) & jnp.where(is_tri, ok_t, ok_q)
          & (t >= tmin) & (t < best_t))
    return jnp.where(ok, t, INF)


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, nodes_ref,
            prims_ref, t_ref, row_ref, *, n_leaves, tmin, tmax):
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    inv = (1.0 / d[0], 1.0 / d[1], 1.0 / d[2])
    best_t = jnp.full((BLOCK,), tmax, jnp.float32)
    best_row = jnp.full((BLOCK,), -1, jnp.int32)
    # zero-direction lanes (padding, parked queue lanes) never start
    live = (d[0] != 0.0) | (d[1] != 0.0) | (d[2] != 0.0)
    one = jnp.ones((BLOCK,), jnp.int32)
    root_hit, _ = _slab(nodes_ref, one, o, inv, best_t, live)
    state = (one, one * 0, (~root_hit).astype(jnp.int32), best_t, best_row)

    def cond(state):
        return jnp.min(state[2]) == 0

    def body(state):
        j, trail, done_i, best_t, best_row = state
        active = done_i == 0
        at_leaf = j >= n_leaves
        inner = active & ~at_leaf

        # internal node: test both children, enter the nearer hit one
        c0 = 2 * j
        h0, n0 = _slab(nodes_ref, c0, o, inv, best_t, inner)
        h1, n1 = _slab(nodes_ref, c0 + 1, o, inv, best_t, inner)
        both = h0 & h1
        first = jnp.where(both, jnp.where(n1 < n0, c0 + 1, c0),
                          jnp.where(h0, c0, c0 + 1))
        descend = h0 | h1

        # leaf: intersect its primitives
        at_leaf_act = active & at_leaf
        base = (j - n_leaves) * LEAF
        for k in range(LEAF):
            t = _prim_t(prims_ref, base + k, o, d, tmin, best_t, at_leaf_act)
            better = t < best_t
            best_t = jnp.where(better, t, best_t)
            best_row = jnp.where(better, base + k, best_row)

        # pop: climb past the trailing zero bits, enter the far sibling
        pop = active & ~descend
        low = trail & (-trail)
        k = jnp.where(trail == 0, 0, jax.lax.population_count(low - 1))
        up = jax.lax.shift_right_logical(j, k) ^ 1
        up_trail = jax.lax.shift_right_logical(trail, k) ^ 1
        finished = pop & (trail == 0)

        j = jnp.where(descend, first, jnp.where(pop, up, j))
        trail = jnp.where(descend, (trail << 1) | both.astype(jnp.int32),
                          jnp.where(pop, up_trail, trail))
        done_i = jnp.where(finished, 1, done_i)
        return j, trail, done_i, best_t, best_row

    _, _, _, best_t, best_row = jax.lax.while_loop(cond, body, state)
    t_ref[...] = best_t
    row_ref[...] = best_row


@functools.partial(jax.jit, static_argnames=("n_leaves", "tmin", "tmax",
                                             "interpret"))
def _planar_hit(nodes, prims, o, d, *, n_leaves, tmin, tmax, interpret):
    """Kernel launch over R rays (SoA component tuples). Returns (t, row):
    t = INF and row = -1 on miss."""
    r = o[0].shape[0]
    n_pad = (r + BLOCK - 1) // BLOCK * BLOCK

    def pad(c):
        return jnp.pad(c.astype(jnp.float32), (0, n_pad - r))

    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    full = [pl.BlockSpec(nodes.shape, lambda i: (0,)),
            pl.BlockSpec(prims.shape, lambda i: (0,))]
    t, row = pl.pallas_call(
        functools.partial(_kernel, n_leaves=n_leaves, tmin=tmin, tmax=tmax),
        grid=(n_pad // BLOCK,),
        in_specs=[ray_spec] * 6 + full,
        out_specs=(ray_spec, ray_spec),
        out_shape=(jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32)),
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        backend="triton",
        interpret=interpret,
        name="bvh_traverse",
    )(*(pad(c) for c in o), *(pad(c) for c in d), nodes, prims)
    t, row = t[:r], row[:r]
    return jnp.where(row >= 0, t, INF), row


def planar_hit(kbvh, o, d, tmin, tmax=INF, interpret=False):
    """Closest planar primitive per ray through the traversal kernel.
    o, d: (R, 3) arrays or SoA component tuples; tmin/tmax Python floats.
    Returns (t, slot) with slot an index into the unified planar table
    (Solids.pl_*), -1 on miss."""
    from .detached import detached_call

    oc = o if isinstance(o, tuple) else (o[:, 0], o[:, 1], o[:, 2])
    dc = d if isinstance(d, tuple) else (d[:, 0], d[:, 1], d[:, 2])
    t, row = detached_call(_planar_hit, kbvh.nodes, kbvh.prims, oc, dc,
                           n_leaves=kbvh.n_leaves, tmin=float(tmin),
                           tmax=float(tmax), interpret=interpret)
    slot = jnp.where(row >= 0, kbvh.prim_slot[jnp.maximum(row, 0)], -1)
    return t, slot


def bvh_closest_hit_kernel(kbvh, solids, o, d, tmin, tmax=INF,
                           interpret=False):
    """Drop-in for ``accel.bvh_closest_hit``: the traversal kernel over the
    planar primitives, min-combined with the XLA sphere sweep.
    Returns (t, kind, idx)."""
    from .intersect import closest_sphere_hit

    t_p, slot = planar_hit(kbvh, o, d, tmin, tmax, interpret=interpret)
    slot_c = jnp.maximum(slot, 0)
    # a miss reports (kind, idx) = (0, 0), like the walk
    kind = jnp.where(slot < 0, 0, jnp.where(solids.pl_is_tri[slot_c],
                                            KIND_TRIANGLE, KIND_QUAD))
    kind = kind.astype(jnp.int32)
    idx = jnp.where(slot < 0, 0, solids.pl_idx[slot_c])
    if not kbvh.has_spheres:
        return t_p, kind, idx
    oa = jnp.stack(o, -1) if isinstance(o, tuple) else o
    da = jnp.stack(d, -1) if isinstance(d, tuple) else d
    t_s, idx_s = closest_sphere_hit(solids, oa, da, tmin, tmax)
    sphere_wins = t_s <= t_p
    return (jnp.where(sphere_wins, t_s, t_p),
            jnp.where(sphere_wins, KIND_SPHERE, kind).astype(jnp.int32),
            jnp.where(sphere_wins, idx_s, idx))


def closest_hit(cs, o, d, tmin, tmax=INF):
    """Closest solid hit on a BVH scene through the path ``hit_path``
    names. o, d are SoA component tuples. Returns (t, kind, idx)."""
    if hit_path(cs) == "kernel":
        return bvh_closest_hit_kernel(cs.kbvh, cs.solids, o, d, tmin, tmax)
    from ..accel import bvh_closest_hit
    from ..geo import soa

    return bvh_closest_hit(cs.bvh, cs.solids, soa.to_aos(o), soa.to_aos(d),
                           tmin, tmax)
