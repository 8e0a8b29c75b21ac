"""Linear BVH: Morton-ordered complete binary tree, flattened for wavefront
traversal.

The reference builds a pointer-based binary BVH with recursive rayon::join
splits (bvh.rs:84-162) and traverses it per ray with recursion
(bvh.rs:165-180). This design inverts it into data-parallel form:

- build: Morton-code sort of primitive centroids + *complete* binary tree
  over the sorted order (leaves padded to a power of two). A complete tree
  needs no child pointers — node i's children are 2i+1 / 2i+2 — so the
  whole BVH is just two (n_nodes, 3) AABB arrays plus a leaf→primitive
  permutation. Builds run in numpy on host or fully on device in jnp
  (sort + segment reductions), and a C++ builder in native/ covers huge
  scenes.
- traversal: every ray carries an explicit stack in a (R, depth+1) int32
  array; the wavefront pops/tests/pushes in lockstep under a while_loop.
  AABB slab test matches geo/mod.rs:159-188.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import jax
import jax.numpy as jnp
import numpy as np

from ..geo import INF
from ..scene.compile import KIND_QUAD, KIND_SPHERE, KIND_TRIANGLE, Solids

LEAF_SIZE = 4


def _pytree(cls):
    cls = dataclass(frozen=True)(cls)
    jax.tree_util.register_pytree_node(
        cls,
        lambda o: (tuple(getattr(o, f.name) for f in fields(cls)), None),
        lambda _, c: cls(*c))
    return cls


@_pytree
class Bvh:
    node_min: jnp.ndarray   # (2*n_leaves-1, 3)
    node_max: jnp.ndarray
    lp_kind: jnp.ndarray    # (n_leaves*LEAF_SIZE,) int32, -1 = padding
    lp_idx: jnp.ndarray     # (n_leaves*LEAF_SIZE,) int32


class KernelBvh:
    """Layout consumed by the traversal kernel (ops/traverse.py); planar
    primitives only — spheres are swept by the caller.

    - ``nodes`` flat f32, ``(2*n_leaves) * 8``: row j (1-based, row 0
      unused) holds node j's box [minx miny minz maxx maxy maxz 0 0];
      node j's children are 2j and 2j+1, leaves are j >= n_leaves.
    - ``prims`` flat f32, ``n_leaves * LEAF * 16``: leaf k owns rows
      [k*LEAF, (k+1)*LEAF); field layout in ops/traverse.py.
    - ``prim_slot`` int32 per prim row: index into the unified planar
      table (Solids.pl_*), -1 for padding.
    ``n_leaves`` and ``has_spheres`` are static (trace-time) fields."""

    def __init__(self, nodes, prims, prim_slot, n_leaves, has_spheres):
        self.nodes = nodes
        self.prims = prims
        self.prim_slot = prim_slot
        self.n_leaves = int(n_leaves)
        self.has_spheres = bool(has_spheres)


jax.tree_util.register_pytree_node(
    KernelBvh,
    lambda o: ((o.nodes, o.prims, o.prim_slot),
               (o.n_leaves, o.has_spheres)),
    lambda aux, c: KernelBvh(*c, *aux))


def _expand_bits(v):
    """Spread the low 10 bits of v over 30 bits (Morton interleave)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(centroids):
    """30-bit Morton codes of points normalized to the overall AABB."""
    c = np.asarray(centroids, np.float64)
    lo = c.min(axis=0)
    hi = c.max(axis=0)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip(((c - lo) / ext) * 1023.0, 0, 1023).astype(np.uint32)
    return (_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1) | \
        _expand_bits(q[:, 2])


def solids_aabbs(s: Solids):
    """Per-primitive AABBs for the unified prim list (host numpy).

    Quad/triangle AABBs are padded on degenerate axes like the reference
    (quad.rs:45-50, triangle.rs:67, geo/mod.rs:134-156).
    Returns (kinds, idxs, aabb_min, aabb_max) for valid prims only.
    """
    PAD = 1e-4

    def padded(lo, hi):
        pad = (hi - lo) < PAD
        return (np.where(pad, lo - PAD / 2, lo),
                np.where(pad, hi + PAD / 2, hi))

    si = np.nonzero(np.asarray(s.sph_valid))[0]
    sc = np.asarray(s.sph_center, np.float64)[si]
    sr = np.asarray(s.sph_radius, np.float64)[si, None]
    s_lo, s_hi = sc - sr, sc + sr

    qi = np.nonzero(np.asarray(s.qd_valid))[0]
    qq = np.asarray(s.qd_q, np.float64)[qi]
    qu = np.asarray(s.qd_u, np.float64)[qi]
    qv = np.asarray(s.qd_v, np.float64)[qi]
    pts = np.stack([qq, qq + qu, qq + qv, qq + qu + qv], axis=1)
    q_lo, q_hi = padded(pts.min(1), pts.max(1))

    ti = np.nonzero(np.asarray(s.tr_valid))[0]
    tv = np.asarray(s.tr_v0, np.float64)[ti]
    te1 = np.asarray(s.tr_e1, np.float64)[ti]
    te2 = np.asarray(s.tr_e2, np.float64)[ti]
    pts = np.stack([tv, tv + te1, tv + te2], axis=1)
    t_lo, t_hi = padded(pts.min(1), pts.max(1))

    kinds = np.concatenate([np.full(len(si), KIND_SPHERE, np.int32),
                            np.full(len(qi), KIND_QUAD, np.int32),
                            np.full(len(ti), KIND_TRIANGLE, np.int32)])
    idxs = np.concatenate([si, qi, ti]).astype(np.int32)
    mins = np.concatenate([s_lo, q_lo, t_lo], axis=0)
    maxs = np.concatenate([s_hi, q_hi, t_hi], axis=0)
    return kinds, idxs, mins, maxs


# prim count above which the parallel C++ Morton sort (native/) takes over
# from numpy argsort — the counterpart of the reference's rayon::join build
# parallelism (bvh.rs:100-103)
NATIVE_SORT_THRESHOLD = 100_000


def median_split_order(mins, maxs, leaf_size, n_leaves):
    """Leaf ordering by recursive most-spread-axis median splits — the
    reference's split rule (bvh.rs:116-162) adapted to the complete-tree
    layout: each split puts the first half-capacity of the sorted segment in
    the left subtree, so node j at level l covers exactly leaves
    [j*2^(L-l), (j+1)*2^(L-l)) and the flattened pointer-free layout holds.
    Every segment except the trailing ones is full, so primitives sit
    densely in leaf-slot order.

    Produces far tighter boxes than a Morton sort. Vectorized per tree
    level: the segments of a level tile [0, n), so one lexsort by
    (segment, centroid on the segment's split axis) splits them all.
    Returns a permutation of range(n)."""
    c = (np.asarray(mins, np.float64) + np.asarray(maxs, np.float64)) * 0.5
    n = c.shape[0]
    order = np.arange(n)
    starts = np.array([0])
    ends = np.array([n])
    nl = n_leaves
    while nl > 1 and n > 1:
        lens = ends - starts
        seg_id = np.repeat(np.arange(len(starts)), lens)
        cs = c[order]
        full = lens > 0
        lo = np.zeros((len(starts), 3))
        hi = np.zeros((len(starts), 3))
        lo[full] = np.minimum.reduceat(cs, starts[full], axis=0)
        hi[full] = np.maximum.reduceat(cs, starts[full], axis=0)
        axis = np.argmax(hi - lo, axis=1)
        key = cs[np.arange(n), axis[seg_id]]
        order = order[np.lexsort((key, seg_id))]
        split = np.minimum(lens, (nl // 2) * leaf_size)
        mid = starts + split
        starts = np.stack([starts, mid], 1).reshape(-1)
        ends = np.stack([mid, ends], 1).reshape(-1)
        nl //= 2
    return order


def build_bvh(s: Solids, leaf_size=LEAF_SIZE) -> Bvh:
    """Host-side LBVH build: Morton sort + complete-tree AABBs. numpy for
    small scenes; the native C++ parallel sort for large ones."""
    kinds, idxs, mins, maxs = solids_aabbs(s)
    n = len(kinds)
    order = None
    if n >= NATIVE_SORT_THRESHOLD:
        from ..native import lbvh_sort

        order = lbvh_sort(mins.astype(np.float32), maxs.astype(np.float32))
    if order is None:
        order = np.argsort(morton_codes((mins + maxs) / 2.0), kind="stable")
    kinds, idxs = kinds[order], idxs[order]
    mins, maxs = mins[order], maxs[order]

    n_leaves = max(1, 1 << int(np.ceil(np.log2(max(1, (n + leaf_size - 1)
                                                   // leaf_size)))))
    n_slots = n_leaves * leaf_size
    lp_kind = np.full(n_slots, -1, np.int32)
    lp_idx = np.zeros(n_slots, np.int32)
    lp_kind[:n] = kinds
    lp_idx[:n] = idxs

    # leaf AABBs
    slot_min = np.full((n_slots, 3), np.inf)
    slot_max = np.full((n_slots, 3), -np.inf)
    slot_min[:n] = mins
    slot_max[:n] = maxs
    leaf_min = slot_min.reshape(n_leaves, leaf_size, 3).min(1)
    leaf_max = slot_max.reshape(n_leaves, leaf_size, 3).max(1)

    n_nodes = 2 * n_leaves - 1
    nodes = None
    if n >= NATIVE_SORT_THRESHOLD:
        from ..native import lbvh_nodes

        nodes = lbvh_nodes(slot_min.astype(np.float32),
                           slot_max.astype(np.float32), leaf_size)
    if nodes is not None:
        node_min, node_max = nodes
    else:
        node_min = np.full((n_nodes, 3), np.inf)
        node_max = np.full((n_nodes, 3), -np.inf)
        node_min[n_leaves - 1:] = leaf_min
        node_max[n_leaves - 1:] = leaf_max
        # bottom-up, one vectorized reduction per tree level
        lvl_min, lvl_max = leaf_min, leaf_max
        while lvl_min.shape[0] > 1:
            lvl_min = lvl_min.reshape(-1, 2, 3).min(1)
            lvl_max = lvl_max.reshape(-1, 2, 3).max(1)
            base = lvl_min.shape[0] - 1
            node_min[base:base + lvl_min.shape[0]] = lvl_min
            node_max[base:base + lvl_max.shape[0]] = lvl_max

    # numpy-backed (host): compile_scene converts to device arrays in one
    # pass; direct callers can use it on any backend.
    return Bvh(node_min=node_min.astype(np.float32),
               node_max=node_max.astype(np.float32),
               lp_kind=lp_kind, lp_idx=lp_idx)


def build_kernel_bvh(s: Solids):
    """Planar-only complete tree in the traversal-kernel layout (see
    KernelBvh), leaves in median-split order. Host-side numpy build."""
    from ..ops.traverse import (LEAF, NODE_F, PRIM_EMPTY, PRIM_F,
                                PRIM_KIND, PRIM_QUAD, PRIM_TRI)

    PAD = 1e-4

    def padded(lo, hi):
        pad = (hi - lo) < PAD
        return (np.where(pad, lo - PAD / 2, lo),
                np.where(pad, hi + PAD / 2, hi))

    Q = np.asarray(s.qd_valid).shape[0]
    qi = np.nonzero(np.asarray(s.qd_valid))[0]
    qq = np.asarray(s.qd_q, np.float64)[qi]
    qu = np.asarray(s.qd_u, np.float64)[qi]
    qv = np.asarray(s.qd_v, np.float64)[qi]
    pts = np.stack([qq, qq + qu, qq + qv, qq + qu + qv], axis=1)
    q_lo, q_hi = padded(pts.min(1), pts.max(1))

    ti = np.nonzero(np.asarray(s.tr_valid))[0]
    tv = np.asarray(s.tr_v0, np.float64)[ti]
    te1 = np.asarray(s.tr_e1, np.float64)[ti]
    te2 = np.asarray(s.tr_e2, np.float64)[ti]
    pts = np.stack([tv, tv + te1, tv + te2], axis=1)
    t_lo, t_hi = padded(pts.min(1), pts.max(1))

    slots = np.concatenate([qi, Q + ti]).astype(np.int32)
    mins = np.concatenate([q_lo, t_lo], axis=0)
    maxs = np.concatenate([q_hi, t_hi], axis=0)
    n = slots.shape[0]

    n_leaves = max(2, 1 << int(np.ceil(np.log2(max(1, (n + LEAF - 1)
                                                   // LEAF)))))
    order = median_split_order(mins, maxs, LEAF, n_leaves)
    slots, mins, maxs = slots[order], mins[order], maxs[order]
    n_slots = n_leaves * LEAF

    # primitive rows: triangles as (v0, e1, e2), quads as the plane
    # functional (n, d, g1, g1o, g2, g2o) of the unified planar table
    quad_cols = np.concatenate(
        [np.asarray(s.pl_n, np.float32),
         np.asarray(s.pl_d, np.float32)[:, None],
         np.asarray(s.pl_g1, np.float32),
         np.asarray(s.pl_g1o, np.float32)[:, None],
         np.asarray(s.pl_g2, np.float32),
         np.asarray(s.pl_g2o, np.float32)[:, None]], axis=1)
    tri_cols = np.concatenate(
        [np.zeros((Q, 9), np.float32),
         np.concatenate([np.asarray(s.tr_v0, np.float32),
                         np.asarray(s.tr_e1, np.float32),
                         np.asarray(s.tr_e2, np.float32)], axis=1)], axis=0)
    is_tri = slots >= Q
    prims = np.zeros((n_slots, PRIM_F), np.float32)
    prims[:n, :12] = quad_cols[slots]
    prims[:n, :9] = np.where(is_tri[:, None], tri_cols[slots],
                             prims[:n, :9])
    prims[:, PRIM_KIND] = PRIM_EMPTY
    prims[:n, PRIM_KIND] = np.where(is_tri, PRIM_TRI, PRIM_QUAD)
    prim_slot = np.full(n_slots, -1, np.int32)
    prim_slot[:n] = slots

    slot_min = np.full((n_slots, 3), np.inf)
    slot_max = np.full((n_slots, 3), -np.inf)
    slot_min[:n] = mins
    slot_max[:n] = maxs
    # 1-based complete tree: level l holds nodes [2^l, 2^(l+1))
    node_min = np.full((2 * n_leaves, 3), np.inf)
    node_max = np.full((2 * n_leaves, 3), -np.inf)
    lvl_min = slot_min.reshape(n_leaves, LEAF, 3).min(1)
    lvl_max = slot_max.reshape(n_leaves, LEAF, 3).max(1)
    node_min[n_leaves:] = lvl_min
    node_max[n_leaves:] = lvl_max
    while lvl_min.shape[0] > 1:
        lvl_min = lvl_min.reshape(-1, 2, 3).min(1)
        lvl_max = lvl_max.reshape(-1, 2, 3).max(1)
        base = lvl_min.shape[0]
        node_min[base:2 * base] = lvl_min
        node_max[base:2 * base] = lvl_max
    # Empty subtrees (all-padding leaves) have inverted +inf/-inf boxes,
    # which the slab test HITS (near=max(min(+inf,-inf),0)=0 < far=+inf):
    # store them as a degenerate far-away point box (min==max) so the
    # strict near<far test misses and the walk never enters them.
    empty = ~(node_min[:, 0] <= node_max[:, 0])
    node_min[empty] = 1e30
    node_max[empty] = 1e30
    nodes = np.zeros((2 * n_leaves, NODE_F), np.float32)
    nodes[:, 0:3] = node_min
    nodes[:, 3:6] = node_max
    return KernelBvh(nodes=nodes.reshape(-1), prims=prims.reshape(-1),
                     prim_slot=prim_slot, n_leaves=n_leaves,
                     has_spheres=bool(np.asarray(s.sph_valid).any()))


def build_bvh_device(aabb_min, aabb_max, kinds, idxs, leaf_size=LEAF_SIZE):
    """On-device LBVH build (jnp): Morton sort + bottom-up level reductions.

    Takes per-prim AABBs as device arrays; returns a Bvh. All steps are
    XLA-compilable (sort, gather, reshape-reduce by levels), fulfilling the
    'LBVH built on-device' requirement for dynamic scenes.
    """
    n = aabb_min.shape[0]
    centroid = (aabb_min + aabb_max) * 0.5
    lo = jnp.min(centroid, axis=0)
    hi = jnp.max(centroid, axis=0)
    ext = jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip((centroid - lo) / ext * 1023.0, 0, 1023).astype(jnp.uint32)

    def expand(v):
        v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
        v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
        v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
        v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
        return v

    code = (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(q[:, 2])
    order = jnp.argsort(code)
    kinds = kinds[order]
    idxs = idxs[order]
    mins = aabb_min[order]
    maxs = aabb_max[order]

    n_leaves = max(1, 1 << int(np.ceil(np.log2(max(1, (n + leaf_size - 1)
                                                   // leaf_size)))))
    n_slots = n_leaves * leaf_size
    pad = n_slots - n
    lp_kind = jnp.concatenate([kinds, jnp.full((pad,), -1, jnp.int32)])
    lp_idx = jnp.concatenate([idxs, jnp.zeros((pad,), jnp.int32)])
    slot_min = jnp.concatenate([mins, jnp.full((pad, 3), INF)])
    slot_max = jnp.concatenate([maxs, jnp.full((pad, 3), -INF)])

    level_min = slot_min.reshape(n_leaves, leaf_size, 3).min(1)
    level_max = slot_max.reshape(n_leaves, leaf_size, 3).max(1)
    levels_min = [level_min]
    levels_max = [level_max]
    while levels_min[-1].shape[0] > 1:
        m = levels_min[-1].reshape(-1, 2, 3)
        x = levels_max[-1].reshape(-1, 2, 3)
        levels_min.append(m.min(1))
        levels_max.append(x.max(1))
    node_min = jnp.concatenate(levels_min[::-1], axis=0)
    node_max = jnp.concatenate(levels_max[::-1], axis=0)
    return Bvh(node_min=node_min.astype(jnp.float32),
               node_max=node_max.astype(jnp.float32),
               lp_kind=lp_kind, lp_idx=lp_idx)


def _slab_hit(o, d, t_min_limit, t_max_limit, nmin, nmax):
    """Branchless slab test matching Aabb::hit (geo/mod.rs:159-188): the
    running interval starts at [0, inf) and must stay non-empty (strict)."""
    inv = 1.0 / d
    t0 = (nmin - o) * inv
    t1 = (nmax - o) * inv
    near = jnp.minimum(t0, t1)
    far = jnp.maximum(t0, t1)
    t_min = jnp.maximum(jnp.max(near, axis=-1), 0.0)
    t_max = jnp.min(far, axis=-1)
    # non-empty interval (strict, like the reference), and not entirely
    # beyond the current closest hit
    return (t_min < t_max) & (t_min <= t_max_limit)


def _intersect_one(s: Solids, kind, idx, o, d, tmin, tmax):
    """Single-primitive intersection per ray, dispatched on kind."""
    from ..ops import intersect as I

    # sphere
    c = s.sph_center[idx]
    r = s.sph_radius[idx]
    oc = o - c
    a = jnp.sum(d * d, -1)
    half_b = jnp.sum(oc * d, -1)
    c2 = jnp.sum(oc * oc, -1) - r * r
    disc = half_b * half_b - a * c2
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    r1 = (-half_b - sq) / a
    r2 = (-half_b + sq) / a
    ok = disc >= 0.0
    ts = jnp.where(ok & (r1 >= tmin) & (r1 <= tmax), r1,
                   jnp.where(ok & (r2 >= tmin) & (r2 <= tmax), r2, INF))

    # quad
    qn = s.qd_normal[idx]
    denom = jnp.sum(qn * d, -1)
    t = (s.qd_d[idx] - jnp.sum(qn * o, -1)) / denom
    hp = o + d * t[..., None]
    pv = hp - s.qd_q[idx]
    w = s.qd_w[idx]
    pu = jnp.sum(w * jnp.cross(pv, s.qd_v[idx]), -1)
    pvv = jnp.sum(w * jnp.cross(s.qd_u[idx], pv), -1)
    okq = ((jnp.abs(denom) >= 1e-8) & (pu >= 0) & (pu <= 1) & (pvv >= 0)
           & (pvv <= 1) & (t >= tmin) & (t <= tmax))
    tq = jnp.where(okq, t, INF)

    # triangle
    e1 = s.tr_e1[idx]
    e2 = s.tr_e2[idx]
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, -1)
    invd = 1.0 / det
    tvec = o - s.tr_v0[idx]
    qvec = jnp.cross(tvec, e1)
    bu = jnp.sum(tvec * pvec, -1) * invd
    bv = jnp.sum(d * qvec, -1) * invd
    tt = jnp.sum(e2 * qvec, -1) * invd
    okt = ((jnp.abs(det) >= 1e-8) & (bu >= 0) & (bu <= 1) & (bv >= 0)
           & (bu + bv <= 1) & (tt >= tmin) & (tt <= tmax))
    ttv = jnp.where(okt, tt, INF)

    t = jnp.where(kind == KIND_SPHERE, ts,
                  jnp.where(kind == KIND_QUAD, tq, ttv))
    return jnp.where(kind < 0, INF, t)


def bvh_closest_hit(bvh: Bvh, s: Solids, o, d, tmin, tmax, leaf_size=LEAF_SIZE):
    """Wavefront stack traversal. Returns (t, kind, idx) like
    ops.intersect.closest_solid_hit."""
    # accept host (numpy-backed) Bvh/Solids from direct build_bvh callers
    bvh = jax.tree.map(jnp.asarray, bvh)
    s = jax.tree.map(jnp.asarray, s)
    R = o.shape[0]
    n_nodes = bvh.node_min.shape[0]
    n_leaves = (n_nodes + 1) // 2
    depth = int(np.log2(n_leaves)) + 1
    stack_size = depth + 2

    tmin_b = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (R,))
    tmax_b = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (R,))

    stack = jnp.zeros((R, stack_size), jnp.int32)
    sp = jnp.ones((R,), jnp.int32)          # root pushed
    best_t = tmax_b
    best_kind = jnp.zeros((R,), jnp.int32)
    best_idx = jnp.zeros((R,), jnp.int32)
    rr = jnp.arange(R)

    def cond(state):
        _, sp, *_ = state
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, best_t, best_kind, best_idx = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = stack[rr, top]
        sp = jnp.where(active, sp - 1, sp)

        nmin = bvh.node_min[node]
        nmax = bvh.node_max[node]
        hit = _slab_hit(o, d, tmin_b, best_t, nmin, nmax) & active

        is_leaf = node >= (n_leaves - 1)
        push = hit & ~is_leaf
        right = 2 * node + 2
        left = 2 * node + 1
        stack2 = stack.at[rr, jnp.minimum(sp, stack_size - 1)].set(
            jnp.where(push, right, stack[rr, jnp.minimum(sp, stack_size - 1)]))
        sp = jnp.where(push, sp + 1, sp)
        stack2 = stack2.at[rr, jnp.minimum(sp, stack_size - 1)].set(
            jnp.where(push, left, stack2[rr, jnp.minimum(sp, stack_size - 1)]))
        sp = jnp.where(push, sp + 1, sp)

        do_leaf = hit & is_leaf
        leaf_base = (node - (n_leaves - 1)) * leaf_size
        for sidx in range(leaf_size):
            slot = leaf_base + sidx
            kind = bvh.lp_kind[slot]
            idx = bvh.lp_idx[slot]
            t = _intersect_one(s, kind, idx, o, d, tmin_b, best_t)
            better = do_leaf & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            best_kind = jnp.where(better, kind, best_kind)
            best_idx = jnp.where(better, idx, best_idx)

        return stack2, sp, best_t, best_kind, best_idx

    _, _, best_t, best_kind, best_idx = jax.lax.while_loop(
        cond, body, (stack, sp, best_t, best_kind, best_idx))

    t = jnp.where(best_t < tmax_b, best_t, INF)
    return t, best_kind, best_idx
