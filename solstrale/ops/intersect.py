"""Vectorized ray-scene intersection (plain jnp; the BVH traversal kernel
lives in ops/traverse.py).

The reference traverses a pointer-based binary BVH per ray with recursion
(``bvh.rs:165-180``) and per-primitive virtual `hit` calls. Scenes below
``BVH_THRESHOLD`` primitives instead intersect a *wavefront* of R rays
against typed primitive tables in one data-parallel sweep — (R, P)
broadcast work, chunked over P to bound memory. Interval semantics
(inclusive contains, t-min epsilon) follow ``util/interval.rs:25-96``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geo import ALMOST_ZERO, INF, RAY_T_MIN
from ..geo import soa
from ..scene.compile import (KIND_QUAD, KIND_SPHERE, KIND_TRIANGLE,
                             Lights, Solids)

# primitive-chunk size for the (R, P) sweep; bounds peak memory at
# R * CHUNK intermediates.
CHUNK = 2048

# exact one-hot matmul lookups for small tables; beyond this row count
# (where the one-hot FLOPs dominate) fall back to an XLA gather
ONEHOT_MAX_ROWS = 8192

# light_pdf_mean3 statically unrolls its light loop (full-lane SoA ops);
# above this the vectorized (R, L) form wins on HLO size / compile time
_MEAN3_UNROLL_MAX = 16


def _contains(t, tmin, tmax):
    return (t >= tmin) & (t <= tmax)


def _sphere_t(center, radius, valid, o, d, tmin, tmax):
    """Quadratic sphere intersection (sphere.rs:64-83): nearest root in the
    interval, else the far root, else miss. Shapes: o,d (R,3); center (P,3);
    returns t (R,P)."""
    oc = o[:, None, :] - center[None, :, :]
    a = jnp.sum(d * d, -1)[:, None]
    half_b = jnp.sum(oc * d[:, None, :], -1)
    c2 = jnp.sum(oc * oc, -1) - (radius * radius)[None, :]
    disc = half_b * half_b - a * c2
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    r1 = (-half_b - sq) / a
    r2 = (-half_b + sq) / a
    ok = (disc >= 0.0) & valid[None, :]
    t = jnp.where(ok & _contains(r1, tmin, tmax), r1,
                  jnp.where(ok & _contains(r2, tmin, tmax), r2, INF))
    return t


def _quad_t(q, u, v, normal, dpl, w, valid, o, d, tmin, tmax):
    """Plane + planar-coordinates quad intersection (quad.rs:150-173).
    Returns (t, pu, pv) with t=INF on miss."""
    # K=3 elementwise sums, not matmuls: exact f32 on any backend (a
    # float32 matmul may run in TF32)
    denom = jnp.sum(d[:, None, :] * normal[None, :, :], -1)
    t = (dpl[None, :] - jnp.sum(o[:, None, :] * normal[None, :, :], -1)) \
        / denom
    hp = o[:, None, :] + d[:, None, :] * t[..., None]
    pv_vec = hp - q[None, :, :]
    pu = jnp.sum(w[None, :, :] * jnp.cross(pv_vec, v[None, :, :]), -1)
    pvv = jnp.sum(w[None, :, :] * jnp.cross(u[None, :, :], pv_vec), -1)
    ok = ((jnp.abs(denom) >= ALMOST_ZERO) & valid[None, :]
          & (pu >= 0.0) & (pu <= 1.0) & (pvv >= 0.0) & (pvv <= 1.0)
          & _contains(t, tmin, tmax))
    return jnp.where(ok, t, INF), pu, pvv


def _tri_t(v0, e1, e2, valid, o, d, tmin, tmax):
    """Möller–Trumbore (triangle.rs:119-148). Returns (t, bu, bv)."""
    p_vec = jnp.cross(d[:, None, :], e2[None, :, :])
    det = jnp.sum(e1[None, :, :] * p_vec, -1)
    inv_det = 1.0 / det
    t_vec = o[:, None, :] - v0[None, :, :]
    q_vec = jnp.cross(t_vec, e1[None, :, :])
    bu = jnp.sum(t_vec * p_vec, -1) * inv_det
    bv = jnp.sum(d[:, None, :] * q_vec, -1) * inv_det
    tt = jnp.sum(e2[None, :, :] * q_vec, -1) * inv_det
    ok = ((jnp.abs(det) >= ALMOST_ZERO) & valid[None, :]
          & (bu >= 0.0) & (bu <= 1.0) & (bv >= 0.0) & (bu + bv <= 1.0)
          & _contains(tt, tmin, tmax))
    return jnp.where(ok, tt, INF), bu, bv


def _min_over_prims(t):
    """(R, P) t-matrix → (t_min, argmin) per ray."""
    idx = jnp.argmin(t, axis=1)
    return jnp.take_along_axis(t, idx[:, None], axis=1)[:, 0], idx.astype(jnp.int32)


def _chunk_scan(fn, n_prims, r):
    """Run fn(start, size) over prim chunks, keeping the running (t, idx) min.
    fn returns a (R, size) t-matrix for prims [start, start+size)."""
    best_t = jnp.full((r,), INF, jnp.float32)
    best_i = jnp.zeros((r,), jnp.int32)
    for start in range(0, n_prims, CHUNK):
        size = min(CHUNK, n_prims - start)
        t = fn(start, size)
        ct, ci = _min_over_prims(t)
        take = ct < best_t
        best_t = jnp.where(take, ct, best_t)
        best_i = jnp.where(take, ci + start, best_i)
    return best_t, best_i


def _mm(a, b):
    """(R,3) x (3,P) matmul at full f32 accuracy.

    HIGHEST precision is required: a DEFAULT-precision f32 matmul may run
    in a reduced-precision mode (TF32 keeps 10 mantissa bits), which
    corrupts world-space geometry functionals (plane offsets, barycentric
    coefficients) enough to miss hits."""
    return jnp.dot(a, b, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def _sphere_t_mm(center, radius, valid, o, d, od, oo, dd, tmin, tmax):
    """Sphere sweep in matmul form: the oc·d and |oc|² broadcasts expand to
    D@Cᵀ / O@Cᵀ products + per-ray scalars (sphere.rs:64-83)."""
    ct = center.T  # (3, P)
    half_b = od[:, None] - _mm(d, ct)
    c2 = oo[:, None] - 2.0 * _mm(o, ct) + \
        (jnp.sum(center * center, -1) - radius * radius)[None, :]
    a = dd[:, None]
    disc = half_b * half_b - a * c2
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    r1 = (-half_b - sq) / a
    r2 = (-half_b + sq) / a
    ok = (disc >= 0.0) & valid[None, :]
    return jnp.where(ok & _contains(r1, tmin, tmax), r1,
                     jnp.where(ok & _contains(r2, tmin, tmax), r2, INF))


def _planar_t_mm(n, dpl, g1, g1o, g2, g2o, is_tri, valid, o, d, tmin, tmax):
    """Unified quad/tri sweep: plane-equation t + two affine barycentric
    functionals, all as (R,3)x(3,P) matmuls. Containment rule selected per
    prim (quad.rs:150-173 semantics for quads, triangle.rs:119-148 — via
    the dual basis — for tris)."""
    denom = _mm(d, n.T)
    t = (dpl[None, :] - _mm(o, n.T)) / denom
    u = _mm(o, g1.T) + t * _mm(d, g1.T) + g1o[None, :]
    v = _mm(o, g2.T) + t * _mm(d, g2.T) + g2o[None, :]
    contain = jnp.where(
        is_tri[None, :],
        (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0),
        (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0))
    ok = ((jnp.abs(denom) >= ALMOST_ZERO) & valid[None, :] & contain
          & _contains(t, tmin, tmax))
    return jnp.where(ok, t, INF)


def closest_sphere_hit(s: Solids, o, d, tmin, tmax):
    """Closest sphere hit per ray (XLA sweep). Returns (t, idx)."""
    r = o.shape[0]
    if jnp.ndim(tmin):
        tmin = tmin.reshape(r, 1)
    if jnp.ndim(tmax):
        tmax = tmax.reshape(r, 1)
    od = jnp.sum(o * d, -1)
    oo = jnp.sum(o * o, -1)
    dd = jnp.sum(d * d, -1)
    return _chunk_scan(
        lambda a, n: _sphere_t_mm(s.sph_center[a:a + n],
                                   s.sph_radius[a:a + n],
                                   s.sph_valid[a:a + n], o, d, od, oo, dd,
                                   tmin, tmax),
        s.sph_center.shape[0], r)


def closest_solid_hit(s: Solids, o, d, tmin, tmax):
    """Closest hit over all solid tables (brute-force sweeps).

    Returns (t, kind, idx); t = INF on miss. tmin/tmax broadcast over (R,).
    """
    ts, is_ = closest_sphere_hit(s, o, d, tmin, tmax)
    r = o.shape[0]
    if jnp.ndim(tmin):
        tmin = tmin.reshape(r, 1)
    if jnp.ndim(tmax):
        tmax = tmax.reshape(r, 1)
    tp, ip = _chunk_scan(
        lambda a, n: _planar_t_mm(s.pl_n[a:a + n], s.pl_d[a:a + n],
                                   s.pl_g1[a:a + n], s.pl_g1o[a:a + n],
                                   s.pl_g2[a:a + n], s.pl_g2o[a:a + n],
                                   s.pl_is_tri[a:a + n], s.pl_valid[a:a + n],
                                   o, d, tmin, tmax),
        s.pl_n.shape[0], r)

    kind_p = jnp.where(s.pl_is_tri[ip], KIND_TRIANGLE, KIND_QUAD) \
        .astype(jnp.int32)
    idx_p = s.pl_idx[ip]

    sphere_wins = ts <= tp
    t = jnp.where(sphere_wins, ts, tp)
    kind = jnp.where(sphere_wins, KIND_SPHERE, kind_p).astype(jnp.int32)
    idx = jnp.where(sphere_wins, is_, idx_p)
    return t, kind, idx


def onehot_matmul(idx, n_rows, table, chunk=CHUNK):
    """Gather-free row lookup: rows of `table` selected by `idx` via an
    exact one-hot (R, P) x (P, K) matmul at HIGHEST precision.

    Above ONEHOT_MAX_ROWS the FLOP cost (R x P x K) dwarfs the gather cost
    and the lookup falls back to a plain XLA row gather — at sponza scale
    (262k prims) the one-hot form would be ~1 TFLOP per bounce."""
    r = idx.shape[0]
    if n_rows > ONEHOT_MAX_ROWS:
        row = table[jnp.clip(idx, 0, n_rows - 1)].astype(jnp.float32)
        # match one-hot semantics exactly: out-of-range idx yields a zero row
        in_range = (idx >= 0) & (idx < n_rows)
        return jnp.where(in_range[:, None], row, 0.0)
    out = jnp.zeros((r, table.shape[1]), jnp.float32)
    for a in range(0, n_rows, chunk):
        size = min(chunk, n_rows - a)
        cols = jnp.arange(a, a + size, dtype=idx.dtype)
        oh = (idx[:, None] == cols[None, :]).astype(jnp.float32)
        # HIGHEST precision: a reduced-precision matmul (bf16, TF32)
        # rounds integer-valued table entries above 2^8 / 2^11
        # (texture-arena offsets, material/texture ids) to the wrong
        # value — the lookup must be exact
        out = out + jnp.dot(oh, table[a:a + size],
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
    return out


def onehot_matmul_t(idx, n_rows, table, chunk=CHUNK):
    """Transposed one-hot lookup: returns rows-as-fields (K, R) directly.
    The one-hot is built in (P, R) orientation so no relayout of the (R, K)
    result is ever materialized — each output row is a full-lane (R,) array
    (geo/soa.py). Above ONEHOT_MAX_ROWS falls back to a row gather + one
    transpose."""
    r = idx.shape[0]
    if n_rows > ONEHOT_MAX_ROWS:
        row = table[jnp.clip(idx, 0, n_rows - 1)].astype(jnp.float32)
        in_range = (idx >= 0) & (idx < n_rows)
        return jnp.where(in_range[:, None], row, 0.0).T
    out = jnp.zeros((table.shape[1], r), jnp.float32)
    for a in range(0, n_rows, chunk):
        size = min(chunk, n_rows - a)
        cols = jnp.arange(a, a + size, dtype=idx.dtype)
        oh = (cols[:, None] == idx[None, :]).astype(jnp.float32)
        # HIGHEST precision: a reduced-precision matmul rounds
        # integer-valued table entries to the wrong value
        out = out + jnp.dot(table[a:a + size].T, oh,
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
    return out


def hit_attributes_soa(s: Solids, o, d, t, kind, idx, has_spheres=True):
    """Recompute full hit attributes for winning (kind, idx, t) in SoA form
    (o, d and all returned vectors are component tuples; uv is (u, v)):
    winner parameters come from one one-hot matmul / row gather over the
    compile-time attribute tables, transposed ONCE so every later op runs
    on full-lane (R,) arrays (geo/soa.py has the layout rationale).

    Mirrors RayHit construction in sphere.rs:84-107 / quad.rs:164-193 /
    triangle.rs:142-172: geometric normal flipped to face the ray, tangent
    frame for bump mapping, texture UV, front_face flag, material id.

    has_spheres=False (a trace-time constant from the compiled scene's
    "spheres" feature) skips the whole sphere branch — the spherical-uv
    arccos/arctan2 transcendentals are the most expensive ops here, and a
    sphere-free scene (the sponza fixture) pays them per bounce for
    nothing.
    """
    point = (o[0] + d[0] * t, o[1] + d[1] * t, o[2] + d[2] * t)
    n_q = s.qd_q.shape[0]
    n_pl = s.pl_attr.shape[0]

    is_s = (kind == KIND_SPHERE)
    planar_slot = jnp.where(kind == KIND_TRIANGLE, n_q + idx, idx)
    planar_slot = jnp.clip(planar_slot, 0, n_pl - 1)
    ap = onehot_matmul_t(planar_slot, n_pl, s.pl_attr)    # (24, R)

    # --- planar derived (quad.rs:164-193 / triangle.rs:142-172) ---
    n = (ap[0], ap[1], ap[2])
    bu = soa.dot3(point, (ap[3], ap[4], ap[5])) + ap[6]
    bv = soa.dot3(point, (ap[7], ap[8], ap[9])) + ap[10]
    tangent_p = (ap[11], ap[12], ap[13])
    bitangent_p = (ap[14], ap[15], ap[16])
    uv_p = (ap[17] + bu * ap[19] + bv * ap[21],
            ap[18] + bu * ap[20] + bv * ap[22])
    mat_p = ap[23]
    front_p = soa.dot3(d, n) < 0.0
    normal_p = soa.where3(front_p, n, soa.vneg(n))

    if not has_spheres:
        return dict(
            point=point, normal=normal_p, tangent=tangent_p,
            bitangent=bitangent_p, uv=uv_p, front_face=front_p,
            mat=mat_p.astype(jnp.int32),
        )

    n_sph = s.sph_attr.shape[0]
    asp = onehot_matmul_t(jnp.clip(idx, 0, n_sph - 1), n_sph, s.sph_attr)

    # --- sphere derived (sphere.rs:84-107) ---
    c = (asp[0], asp[1], asp[2])
    n_raw = soa.vsub(point, c)
    n_unit = soa.unit3(n_raw)
    front_s = soa.dot3(d, n_unit) < 0.0
    normal_s = soa.where3(front_s, n_unit, soa.vneg(n_unit))
    theta = jnp.arccos(jnp.clip(-n_unit[1], -1.0, 1.0))
    phi = -jnp.arctan2(n_unit[2], n_unit[0]) + jnp.pi
    uv_s = (phi / (2.0 * jnp.pi), theta / jnp.pi)
    # cross(unit_y, n_raw) with unit_y=(0,1,0) = (n_raw.z, 0, -n_raw.x)
    tangent_s = soa.unit3((n_raw[2], jnp.zeros_like(n_raw[2]), -n_raw[0]))
    bitangent_s = soa.cross3(n_raw, tangent_s)  # unnormalized (sphere.rs:89-90)
    mat_s = asp[4]

    return dict(
        point=point,
        normal=soa.where3(is_s, normal_s, normal_p),
        tangent=soa.where3(is_s, tangent_s, tangent_p),
        bitangent=soa.where3(is_s, bitangent_s, bitangent_p),
        uv=(jnp.where(is_s, uv_s[0], uv_p[0]),
            jnp.where(is_s, uv_s[1], uv_p[1])),
        front_face=jnp.where(is_s, front_s, front_p),
        mat=jnp.where(is_s, mat_s, mat_p).astype(jnp.int32),
    )


def hit_attributes(s: Solids, o, d, t, kind, idx):
    """AoS convenience wrapper over hit_attributes_soa: (R, 3) in/out.
    Returns dict of (R,.) arrays (uv as (R, 2))."""
    a = hit_attributes_soa(s, soa.from_aos(o), soa.from_aos(d), t, kind, idx)
    return dict(
        point=soa.to_aos(a["point"]), normal=soa.to_aos(a["normal"]),
        tangent=soa.to_aos(a["tangent"]),
        bitangent=soa.to_aos(a["bitangent"]),
        uv=jnp.stack(a["uv"], -1), front_face=a["front_face"],
        mat=a["mat"])


def medium_hit(medium, o, d, t_solid, u_flight):
    """Constant-medium scattering distance (constant_medium.rs:35-79).

    Entry = first boundary hit on (-inf, inf), exit = next hit past it;
    exponential free-flight sample decides scattering inside [entry, exit]
    clamped to [RAY_T_MIN, t_solid]. Returns t (INF = no medium event)."""
    t1, _, _ = closest_solid_hit(medium.boundary, o, d, -INF, INF)
    t2, _, _ = closest_solid_hit(medium.boundary, o, d, t1 + 1e-4, INF)
    both = jnp.isfinite(t1) & jnp.isfinite(t2)

    t1c = jnp.maximum(t1, RAY_T_MIN)
    t2c = jnp.minimum(t2, t_solid)
    ordered = t1c < t2c
    t1c = jnp.maximum(t1c, 0.0)

    r_len = jnp.sqrt(jnp.sum(d * d, -1))
    dist_inside = (t2c - t1c) * r_len
    hit_dist = medium.neg_inv_density * jnp.log(jnp.maximum(u_flight, 1e-38))
    scatters = hit_dist <= dist_inside
    t = t1c + hit_dist / r_len
    return jnp.where(both & ordered & scatters, t, INF)


# --- NEE light table ops (pdf.rs:88-102 semantics) ------------------------

def light_pdf_mean3(lights: Lights, o, d, kinds=None):
    """Mean over lights of the per-light sampling pdf, SoA form: o, d are
    (R,) component tuples, result (R,). Statically unrolled over the light
    list so every op runs on contiguous (R,) arrays instead of a narrow
    (R, L) broadcast (geo/soa.py).

    Per-light semantics exactly mirror light_pdf_values: sphere ->
    1/solid-angle gated on a self re-intersection (sphere.rs:40-56),
    quad/tri -> dist^2/(cos*area) (quad.rs:132-143); NaNs propagate
    identically (suppressed later by the shader's NaN filter).

    The static unroll scales HLO size/compile time linearly with light
    count; above _MEAN3_UNROLL_MAX lights fall back to the vectorized
    (R, L) sweep (same math, batched).

    kinds (optional): the compiled scene's static per-light kind tuple —
    with it each light's unrolled step compiles ONLY its own shape branch
    (sphere solid-angle or planar dist²/cosθ·area) instead of both."""
    tmin, tmax = RAY_T_MIN, INF
    n_l = lights.kind.shape[0]
    if kinds is not None and len(kinds) != n_l:
        kinds = None
    if n_l > _MEAN3_UNROLL_MAX:
        return jnp.mean(light_pdf_values(lights, soa.to_aos(o),
                                         soa.to_aos(d)), axis=1)
    dd = soa.dot3(d, d)
    acc = jnp.zeros_like(o[0])
    for i in range(n_l):
        kind_i = lights.kind[i]
        static_kind = kinds[i] if kinds is not None else None
        if static_kind is not None:
            p0 = (lights.p0[i, 0], lights.p0[i, 1], lights.p0[i, 2])
            if static_kind == KIND_SPHERE:
                oc = soa.vsub(o, p0)
                half_b = soa.dot3(oc, d)
                radius = lights.radius[i]
                dist_sq = soa.dot3(oc, oc)
                c2 = dist_sq - radius * radius
                disc = half_b * half_b - dd * c2
                sq = jnp.sqrt(jnp.maximum(disc, 0.0))
                r1 = (-half_b - sq) / dd
                r2 = (-half_b + sq) / dd
                sph_hit = (disc >= 0.0) & (_contains(r1, tmin, tmax)
                                           | _contains(r2, tmin, tmax))
                cos_theta_max = jnp.sqrt(1.0 - radius * radius / dist_sq)
                solid_angle = 2.0 * jnp.pi * (1.0 - cos_theta_max)
                acc = acc + jnp.where(sph_hit, 1.0 / solid_angle, 0.0)
                continue
            nrm = (lights.normal[i, 0], lights.normal[i, 1],
                   lights.normal[i, 2])
            v_e = (lights.p2[i, 0], lights.p2[i, 1], lights.p2[i, 2])
            u_e = (lights.p1[i, 0], lights.p1[i, 1], lights.p1[i, 2])
            if static_kind == KIND_QUAD:
                denom = soa.dot3(d, nrm)
                t_pl = (lights.d[i] - soa.dot3(o, nrm)) / denom
                hp = (o[0] + d[0] * t_pl, o[1] + d[1] * t_pl,
                      o[2] + d[2] * t_pl)
                pv = soa.vsub(hp, p0)
                w = (lights.w[i, 0], lights.w[i, 1], lights.w[i, 2])
                pu = soa.dot3(w, soa.cross3(pv, v_e))
                pvv = soa.dot3(w, soa.cross3(u_e, pv))
                ok_pl = ((jnp.abs(denom) >= ALMOST_ZERO)
                         & (pu >= 0.0) & (pu <= 1.0) & (pvv >= 0.0)
                         & (pvv <= 1.0) & _contains(t_pl, tmin, tmax))
            else:  # triangle: Moller-Trumbore on (v0, e1, e2)
                pvec = soa.cross3(d, v_e)
                det = soa.dot3(u_e, pvec)
                inv_det = 1.0 / det
                tvec = soa.vsub(o, p0)
                qvec = soa.cross3(tvec, u_e)
                bu = soa.dot3(tvec, pvec) * inv_det
                bv = soa.dot3(d, qvec) * inv_det
                t_pl = soa.dot3(v_e, qvec) * inv_det
                denom = soa.dot3(d, (lights.normal[i, 0],
                                     lights.normal[i, 1],
                                     lights.normal[i, 2]))
                ok_pl = ((jnp.abs(det) >= ALMOST_ZERO)
                         & (bu >= 0.0) & (bu <= 1.0) & (bv >= 0.0)
                         & (bu + bv <= 1.0) & _contains(t_pl, tmin, tmax))
            cos_planar = jnp.abs(denom) / jnp.sqrt(dd)
            acc = acc + jnp.where(
                ok_pl, t_pl * t_pl * dd / (cos_planar * lights.area[i]),
                0.0)
            continue
        p0 = (lights.p0[i, 0], lights.p0[i, 1], lights.p0[i, 2])
        # sphere branch
        oc = soa.vsub(o, p0)
        half_b = soa.dot3(oc, d)
        radius = lights.radius[i]
        dist_sq = soa.dot3(oc, oc)
        c2 = dist_sq - radius * radius
        disc = half_b * half_b - dd * c2
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        r1 = (-half_b - sq) / dd
        r2 = (-half_b + sq) / dd
        sph_hit = (disc >= 0.0) & (_contains(r1, tmin, tmax)
                                   | _contains(r2, tmin, tmax))
        cos_theta_max = jnp.sqrt(1.0 - radius * radius / dist_sq)
        solid_angle = 2.0 * jnp.pi * (1.0 - cos_theta_max)
        pdf_sph = jnp.where(sph_hit, 1.0 / solid_angle, 0.0)

        # planar branch — same per-kind forms as light_pdf_values:
        # quads use the precomputed plane functional (normal, d, w);
        # triangles (whose table rows leave d/w zero) use Moller-Trumbore
        # on (v0, e1, e2)
        nrm = (lights.normal[i, 0], lights.normal[i, 1], lights.normal[i, 2])
        v_e = (lights.p2[i, 0], lights.p2[i, 1], lights.p2[i, 2])
        u_e = (lights.p1[i, 0], lights.p1[i, 1], lights.p1[i, 2])

        denom = soa.dot3(d, nrm)
        tq = (lights.d[i] - soa.dot3(o, nrm)) / denom
        hp = (o[0] + d[0] * tq, o[1] + d[1] * tq, o[2] + d[2] * tq)
        pv = soa.vsub(hp, p0)
        w = (lights.w[i, 0], lights.w[i, 1], lights.w[i, 2])
        pu = soa.dot3(w, soa.cross3(pv, v_e))
        pvv = soa.dot3(w, soa.cross3(u_e, pv))
        okq = ((jnp.abs(denom) >= ALMOST_ZERO)
               & (pu >= 0.0) & (pu <= 1.0) & (pvv >= 0.0) & (pvv <= 1.0)
               & _contains(tq, tmin, tmax))

        pvec = soa.cross3(d, v_e)
        det = soa.dot3(u_e, pvec)
        inv_det = 1.0 / det
        tvec = soa.vsub(o, p0)
        qvec = soa.cross3(tvec, u_e)
        bu = soa.dot3(tvec, pvec) * inv_det
        bv = soa.dot3(d, qvec) * inv_det
        tt = soa.dot3(v_e, qvec) * inv_det
        okt = ((jnp.abs(det) >= ALMOST_ZERO)
               & (bu >= 0.0) & (bu <= 1.0) & (bv >= 0.0) & (bu + bv <= 1.0)
               & _contains(tt, tmin, tmax))

        is_quad = kind_i == KIND_QUAD
        t_pl = jnp.where(is_quad, tq, tt)
        ok_pl = jnp.where(is_quad, okq, okt)
        cos_planar = jnp.abs(denom) / jnp.sqrt(dd)
        pdf_pl = jnp.where(ok_pl,
                           t_pl * t_pl * dd / (cos_planar * lights.area[i]),
                           0.0)
        acc = acc + jnp.where(kind_i == KIND_SPHERE, pdf_sph, pdf_pl)
    return acc / n_l


def sample_light_direction3(lights: Lights, o, pick, r1, r2, kinds=None):
    """SoA light-direction sampling (pdf.rs:98-101): o is a component
    tuple, returns a component tuple. One one-hot lookup transposed once;
    all vector math full-lane. kinds (optional static tuple): when every
    light shares a shape class, only that class's sampler compiles (a
    planar-lights-only scene skips the cone sampler's ONB + sqrt chain
    entirely)."""
    from . import rng as _rng
    from ..geo import soa as _s

    if kinds is not None and len(kinds) != lights.attr.shape[0]:
        kinds = None
    any_sphere = kinds is None or any(k == KIND_SPHERE for k in kinds)
    any_planar = kinds is None or any(k != KIND_SPHERE for k in kinds)

    la = onehot_matmul_t(pick, lights.attr.shape[0], lights.attr)  # (11, R)
    kind = la[0].astype(jnp.int32)
    p0 = (la[1], la[2], la[3])
    p1 = (la[4], la[5], la[6])
    p2 = (la[7], la[8], la[9])
    radius = la[10]

    dir_sphere = dir_planar = None
    if any_sphere:
        # sphere: cone towards center
        to_c = _s.vsub(p0, o)
        dist_sq = _s.dot3(to_c, to_c)
        tan, bit, nrm = _s.onb_from_w3(to_c)
        local = _rng.to_sphere3(radius, dist_sq, r1, r2)
        dir_sphere = _s.onb_local3(tan, bit, nrm, local)

    if any_planar:
        # planar: point on parallelogram
        dir_planar = _s.vsub(_s.vadd(p0, _s.vadd(_s.vscale(p1, r1),
                                                 _s.vscale(p2, r2))), o)

    if not any_planar:
        return dir_sphere
    if not any_sphere:
        return dir_planar
    return _s.where3(kind == KIND_SPHERE, dir_sphere, dir_planar)


def light_pdf_values(lights: Lights, o, d):
    """Per-light pdf of sampling direction d from origin o: (R, L).

    Each light re-intersects the ray against itself with RAY_INTERVAL, then:
    sphere → 1/solid-angle (sphere.rs:40-56), quad/tri → dist²/(cosθ·area)
    (quad.rs:132-143, triangle.rs:100-112). NaN propagates exactly like the
    reference (e.g. origin inside a sphere light) and is later suppressed by
    the shader's NaN filter (shader.rs:109-125).
    """
    tmin, tmax = RAY_T_MIN, INF
    # sphere part
    oc = o[:, None, :] - lights.p0[None, :, :]
    a = jnp.sum(d * d, -1)[:, None]
    half_b = jnp.sum(oc * d[:, None, :], -1)
    c2 = jnp.sum(oc * oc, -1) - (lights.radius * lights.radius)[None, :]
    disc = half_b * half_b - a * c2
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    r1 = (-half_b - sq) / a
    r2 = (-half_b + sq) / a
    sph_hit = (disc >= 0.0) & (_contains(r1, tmin, tmax) | _contains(r2, tmin, tmax))
    dist_sq = jnp.sum(oc * oc, -1)
    cos_theta_max = jnp.sqrt(
        1.0 - (lights.radius * lights.radius)[None, :] / dist_sq)
    solid_angle = 2.0 * jnp.pi * (1.0 - cos_theta_max)
    pdf_sph = jnp.where(sph_hit, 1.0 / solid_angle, 0.0)

    # quad part
    tq, _, _ = _quad_t(lights.p0, lights.p1, lights.p2, lights.normal,
                       lights.d, lights.w,
                       jnp.ones(lights.kind.shape, bool), o, d, tmin, tmax)
    # triangle part
    tt, _, _ = _tri_t(lights.p0, lights.p1, lights.p2,
                      jnp.ones(lights.kind.shape, bool), o, d, tmin, tmax)

    d_len_sq = jnp.sum(d * d, -1)[:, None]
    cos_planar = (jnp.abs(jnp.sum(d[:, None, :] * lights.normal[None, :, :],
                                  -1)) / jnp.sqrt(d_len_sq))
    t_planar = jnp.where(lights.kind[None, :] == KIND_QUAD, tq, tt)
    pdf_planar = jnp.where(
        jnp.isfinite(t_planar),
        t_planar * t_planar * d_len_sq / (cos_planar * lights.area[None, :]),
        0.0)

    return jnp.where(lights.kind[None, :] == KIND_SPHERE, pdf_sph, pdf_planar)


def sample_light_direction(lights: Lights, o, pick, r1, r2):
    """Generate a direction towards the light picked per-ray (pdf.rs:98-101):
    sphere → cone sample (sphere.rs:58-62), quad/tri → uniform parallelogram
    point minus origin (quad.rs:145-148, triangle.rs:114-117)."""
    from . import rng as _rng
    from ..geo import onb_from_w, onb_local

    la = onehot_matmul(pick, lights.attr.shape[0], lights.attr)
    kind = la[:, 0].astype(jnp.int32)
    p0 = la[:, 1:4]
    p1 = la[:, 4:7]
    p2 = la[:, 7:10]
    radius = la[:, 10]

    # sphere: cone towards center
    to_c = p0 - o
    dist_sq = jnp.sum(to_c * to_c, -1)
    tan, bit, nrm = onb_from_w(to_c)
    local = _rng.to_sphere(radius, dist_sq, r1, r2)
    dir_sphere = onb_local(tan, bit, nrm, local)

    # planar: point on parallelogram
    dir_planar = p0 + p1 * r1[..., None] + p2 * r2[..., None] - o

    return jnp.where((kind == KIND_SPHERE)[..., None], dir_sphere, dir_planar)
