"""Traversal kernel (ops/traverse.py) against the XLA walk
(accel.bvh_closest_hit), the kernel layout, the per-platform choice of
closest-hit path, and the light-pdf precision rules."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scenes import (create_sponza_class_scene, create_test_scene,
                    new_bvh_test_scene)
from solstrale import (Bvh, ConstantMedium, Lambertian, RenderConfig,
                       Scene, SolidColor, new_box)
from solstrale.accel import build_kernel_bvh, bvh_closest_hit
from solstrale.geo import INF, RAY_T_MIN
from solstrale.ops import traverse
from solstrale.scene.compile import compile_scene

CFG = RenderConfig(width=8, height=8, samples_per_pixel=1)


def _foggy(cfg):
    base = create_sponza_class_scene(cfg, n_cells=36, textured=False)
    world = list(base.world.children) + [
        ConstantMedium(Bvh(new_box((-8, -1, -8), (8, 8, 8),
                                   Lambertian(SolidColor(1, 1, 1)))),
                       0.05, (0.9, 0.9, 0.9))]
    return Scene(Bvh(world), base.camera, base.background_color, cfg)


SCENES = {
    "kitchen_sink": lambda: create_test_scene(CFG),
    "sponza_36": lambda: create_sponza_class_scene(CFG, n_cells=36),
    "foggy": lambda: _foggy(CFG),
    "triangle_row": lambda: new_bvh_test_scene(CFG, True, 300),
}


def _rays(n, seed, spread, cs=None):
    """Random origins in a box; with a compiled scene, half the rays aim at
    random primitive centres (so most of them hit), the rest are random."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3))
    d = rng.normal(size=(n, 3))
    if cs is not None:
        # primitive centroids: interior points, away from shared edges
        # where containment decisions are rounding-sensitive
        s = jax.tree.map(np.asarray, cs.solids)
        tgt = np.concatenate([
            (s.tr_v0 + (s.tr_e1 + s.tr_e2) / 3)[s.tr_valid],
            (s.qd_q + (s.qd_u + s.qd_v) / 2)[s.qd_valid],
            s.sph_center[s.sph_valid]])
        tgt = tgt[rng.integers(0, len(tgt), n)]
        aim = np.arange(n) % 2 == 0
        d[aim] = tgt[aim] - o[aim]
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def _agree(ref, got, rtol):
    t_r, k_r, i_r = (np.asarray(a) for a in ref)
    t_g, k_g, i_g = (np.asarray(a) for a in got)
    hit = np.isfinite(t_r)
    np.testing.assert_array_equal(hit, np.isfinite(t_g))
    np.testing.assert_allclose(t_r[hit], t_g[hit], rtol=rtol, atol=rtol)
    assert hit.any()
    same = (k_r == k_g) & (i_r == i_g)
    # exact ties (coincident or overlapping coplanar primitives, e.g. the
    # kitchen-sink's ground quad and box bottoms) resolve by visit order,
    # which differs between the Morton-ordered walk and the median-split
    # kernel tree: a different primitive at the same t (to an ulp) agrees
    tie = np.isclose(t_r, t_g, rtol=2e-7, atol=0.0)
    assert (same | tie)[hit].mean() > 0.999


@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_matches_xla_walk(name):
    cs = compile_scene(SCENES[name](), use_bvh=True)
    spread = 160.0 if name == "triangle_row" else 8.0
    o, d = _rays(1500, seed=5, spread=spread, cs=cs)
    ref = bvh_closest_hit(cs.bvh, cs.solids, o, d, RAY_T_MIN, INF)
    got = traverse.bvh_closest_hit_kernel(cs.kbvh, cs.solids, o, d,
                                          RAY_T_MIN, interpret=True)
    # the kernel intersects quads through the plane functional and the walk
    # through quad.rs's cross products: equal up to f32 rounding
    _agree(ref, got, rtol=1e-4)


@pytest.mark.parametrize("n", [1, 127, 129, 300])
def test_kernel_ray_count_not_multiple_of_block(n):
    """Padding lanes (zero direction) never start and are cut off."""
    cs = compile_scene(create_sponza_class_scene(CFG, n_cells=12),
                       use_bvh=True)
    o, d = _rays(n, seed=n, spread=8.0, cs=cs)
    ref = bvh_closest_hit(cs.bvh, cs.solids, o, d, RAY_T_MIN, INF)
    got = traverse.bvh_closest_hit_kernel(cs.kbvh, cs.solids, o, d,
                                          RAY_T_MIN, interpret=True)
    assert got[0].shape == (n,)
    _agree(ref, got, rtol=1e-5)


@pytest.mark.parametrize("kind", ["away", "parked"])
def test_kernel_all_miss(kind):
    """Rays pointing away from the scene, and parked zero-direction rays,
    miss: t = INF, slot = -1."""
    cs = compile_scene(create_sponza_class_scene(CFG, n_cells=12),
                       use_bvh=True)
    n = 200
    o = jnp.tile(jnp.asarray([[0.0, 40.0, 0.0]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    if kind == "parked":
        o = jnp.zeros((n, 3))
        d = jnp.zeros((n, 3))
    t, slot = traverse.planar_hit(cs.kbvh, o, d, RAY_T_MIN, interpret=True)
    assert not np.isfinite(np.asarray(t)).any()
    assert (np.asarray(slot) == -1).all()


def test_kernel_layout():
    """Complete 1-based tree: every primitive appears once, each node's box
    encloses its children's, empty subtrees hold never-hit point boxes."""
    cs = compile_scene(create_test_scene(CFG), use_bvh=False)
    kb = build_kernel_bvh(cs.solids)
    n_leaves = kb.n_leaves
    nodes = np.asarray(kb.nodes).reshape(2 * n_leaves, traverse.NODE_F)
    slots = np.asarray(kb.prim_slot)
    n_planar = int(np.asarray(cs.solids.pl_valid).sum())
    assert sorted(slots[slots >= 0]) == sorted(
        np.nonzero(np.asarray(cs.solids.pl_valid))[0])
    assert (slots >= 0).sum() == n_planar
    # primitives sit densely in leaf-slot order
    assert (slots[:n_planar] >= 0).all() and (slots[n_planar:] == -1).all()
    for j in range(1, n_leaves):
        for c in (2 * j, 2 * j + 1):
            if nodes[c, 0] >= 1e29:
                continue
            assert (nodes[j, 0:3] <= nodes[c, 0:3]).all()
            assert (nodes[j, 3:6] >= nodes[c, 3:6]).all()
    assert not kb.has_spheres or bool(np.asarray(cs.solids.sph_valid).any())


def test_hit_path_per_platform(monkeypatch):
    cs = compile_scene(new_bvh_test_scene(CFG, True, 600))
    assert cs.bvh is not None and cs.kbvh is not None
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert traverse.hit_path(cs) == "xla"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert traverse.hit_path(cs) == "kernel"
    assert traverse.hit_path(dataclasses.replace(cs, kbvh=None)) == "xla"
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="no intersection path"):
        traverse.hit_path(cs)


def test_light_pdf_values_matches_float64():
    """light_pdf_values against a float64 numpy evaluation of the same
    per-light rules (sphere 1/solid-angle, planar dist^2/(cos*area))."""
    from scenes import create_sponza_production_scene
    from solstrale.ops.intersect import light_pdf_values
    from solstrale.scene.compile import KIND_QUAD, KIND_SPHERE

    cs = compile_scene(create_sponza_production_scene(CFG, n_cells=8))
    L = cs.lights
    rng = np.random.default_rng(4)
    n = 4000
    o = rng.uniform(-9, 9, (n, 3)) + np.array([0.0, 5.0, 0.0])
    tgt = np.asarray(L.p0, np.float64)[rng.integers(0, L.kind.shape[0], n)]
    d = tgt - o + rng.normal(scale=0.8, size=(n, 3))
    got = np.asarray(light_pdf_values(L, jnp.asarray(o, jnp.float32),
                                      jnp.asarray(d, jnp.float32)))

    kind = np.asarray(L.kind)
    p0, p1, p2 = (np.asarray(a, np.float64) for a in (L.p0, L.p1, L.p2))
    nrm = np.asarray(L.normal, np.float64)
    want = np.zeros((n, len(kind)))
    dd = (d * d).sum(-1)
    for i, k in enumerate(kind):
        if k == KIND_SPHERE:
            oc = o - p0[i]
            r = float(L.radius[i])
            hb = (oc * d).sum(-1)
            c2 = (oc * oc).sum(-1) - r * r
            disc = hb * hb - dd * c2
            sq = np.sqrt(np.maximum(disc, 0))
            r1, r2 = (-hb - sq) / dd, (-hb + sq) / dd
            hit = (disc >= 0) & ((r1 >= RAY_T_MIN) | (r2 >= RAY_T_MIN))
            cmax = np.sqrt(1 - r * r / (oc * oc).sum(-1))
            want[:, i] = np.where(hit, 1 / (2 * np.pi * (1 - cmax)), 0)
            continue
        if k == KIND_QUAD:
            dn = d @ nrm[i]
            t = (float(L.d[i]) - o @ nrm[i]) / dn
            hp = o + d * t[:, None] - p0[i]
            w = np.asarray(L.w[i], np.float64)
            a = np.cross(hp, p2[i]) @ w
            b = np.cross(p1[i], hp) @ w
            ok = (np.abs(dn) >= 1e-8) & (a >= 0) & (a <= 1) & (b >= 0) \
                & (b <= 1) & (t >= RAY_T_MIN)
        else:
            pv = np.cross(d, p2[i])
            det = pv @ p1[i]
            tv = o - p0[i]
            qv = np.cross(tv, p1[i])
            a = (tv * pv).sum(-1) / det
            b = (d * qv).sum(-1) / det
            t = qv @ p2[i] / det
            ok = (np.abs(det) >= 1e-8) & (a >= 0) & (a <= 1) & (b >= 0) \
                & (a + b <= 1) & (t >= RAY_T_MIN)
        cos = np.abs(d @ nrm[i]) / np.sqrt(dd)
        want[:, i] = np.where(ok, t * t * dd / (cos * float(L.area[i])), 0)
    assert (want > 0).any(axis=0).all(), "every light must be probed"
    # f32 evaluation of the same formulas: borderline containment decisions
    # may flip on a handful of rays, values otherwise agree to ~1e-5
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6)
    assert close.mean() > 0.999, close.mean()


@pytest.mark.gpu
def test_kernel_compiled_on_card(gpu):
    """The compiled kernel (no interpret mode) against the XLA walk."""
    cs = compile_scene(create_sponza_class_scene(CFG, n_cells=64),
                       use_bvh=True)
    o, d = _rays(4096, seed=2, spread=8.0, cs=cs)
    ref = bvh_closest_hit(cs.bvh, cs.solids, o, d, RAY_T_MIN, INF)
    got = traverse.bvh_closest_hit_kernel(cs.kbvh, cs.solids, o, d,
                                          RAY_T_MIN)
    _agree(ref, got, rtol=1e-4)
