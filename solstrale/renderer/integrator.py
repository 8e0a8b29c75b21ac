"""Wavefront path-tracing integrator (pure JAX; jit-compiled end to end).

Data-parallel re-architecture of the reference's recursive ``ray_color``
(``renderer/mod.rs:164-206`` + ``shader.rs:60-125``): instead of per-ray
recursion to depth 50, a *wavefront* of all camera rays advances together
through a bounce loop carrying an SoA ray state.

The reference's nested ``clamp(≤3)+NaN→0`` ScatterPdf semantics
(shader.rs:95-125) — the clamp applies at every recursion level to the
*product* color·prob·L_inner — is folded FORWARD with O(1) per-lane state
using ``min(a·L, 3) = a·min(L, 3/a)`` for a ≥ 0 (multiplication by a
non-negative scalar distributes over min). Unrolling the recursion
L_i = min(a_i · L_{i+1}, 3) with a_i = color_i·prob_i gives

    L_1 = min( (Π_j a_j) · T ,  min_i 3·Π_{j<i} a_j )

so the loop carries only the prefix product A = Π a_j and the running bound
B = min_i 3·A_{i-1} (per channel), plus NaN bookkeeping: a NaN at a pdf
level is filtered (→0) at its own level; a NaN at a basic (metal/dielectric)
level or in the terminal color is filtered by the nearest *outer* pdf level
if one exists, else it propagates to the image exactly as in the reference.
No per-bounce tape and no reverse unwind are needed.

Light transport features (all matching the reference):
- NEE as 50/50 mixture of light-pdf and BSDF-pdf (pdf.rs:36-48), with
  per-light pdf re-intersection (pdf.rs:88-102);
- Lambertian / Metal / Dielectric / DiffuseLight / Isotropic / stochastic
  Blend materials (material/mod.rs);
- constant media with exponential free flight (constant_medium.rs:35-79);
- emission attenuation 1/(1+af·path_length) (material/mod.rs:115-132);
- bump/normal mapping via per-hit tangent frames (material/mod.rs:386-389).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geo import INF, RAY_T_MIN
from ..geo import soa
from ..geo.soa import (dot3, onb_from_w3, onb_local3, reflect3,
                       refract3, unit3, vneg, vscale, where3)
from ..ops import rng, traverse
from ..ops.intersect import (closest_solid_hit, hit_attributes_soa,
                             light_pdf_mean3, medium_hit, onehot_matmul_t,
                             sample_light_direction3)
from ..scene.compile import (BLEND, DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC,
                             KIND_MEDIUM, LAMBERTIAN, METAL, CompiledScene)

MAX_BLEND_DEPTH = 3
_MEDIUM_PURPOSE_BASE = 16  # per-medium free-flight draw purposes


def mat_row(mats, mat_id):
    """Per-ray material parameters via one-hot matmul (gather-free),
    transposed once so each field is a full-lane (R,) row."""
    a = onehot_matmul_t(mat_id, mats.attr.shape[0], mats.attr)
    return dict(kind=a[0].astype(jnp.int32),
                albedo_tex=a[1].astype(jnp.int32),
                normal_tex=a[2].astype(jnp.int32),
                fuzz=a[3], ior=a[4], atten=a[5],
                blend_factor=a[6],
                blend_m1=a[7].astype(jnp.int32),
                blend_m2=a[8].astype(jnp.int32))


def sample_texture(tex, tex_id, uv):
    """Arena texture lookup: nearest neighbor, abs-wrap, flipped v
    (texture.rs:167-180). tex_id = -1 returns black (callers mask).
    uv is an (u, v) tuple of (R,); returns an (r, g, b) channel tuple.
    Texture metadata resolves via one-hot; only the final arena pixel fetch
    is a true gather."""
    tid = jnp.maximum(tex_id, 0)
    ta = onehot_matmul_t(tid, tex.attr.shape[0], tex.attr)
    off = ta[0].astype(jnp.int32)
    w = ta[1].astype(jnp.int32)
    h = ta[2].astype(jnp.int32)
    u = jnp.abs(uv[0]) % 1.0
    v = 1.0 - jnp.abs(uv[1]) % 1.0
    x = (u * (w - 1).astype(jnp.float32)).astype(jnp.int32)
    y = (v * (h - 1).astype(jnp.float32)).astype(jnp.int32)
    idx = off + y * w + x
    px = tex.pixels[idx].T
    return (px[0], px[1], px[2])


def resolve_blend(mats, mat_id, u_levels, features=frozenset(("blend",))):
    """Walk blend chains: pick material_1 if U > blend_factor else material_2,
    independently per level (material/mod.rs:429-444). Identity (free) when
    the compiled scene has no blend materials."""
    if "blend" not in features:
        return mat_id
    for lvl in range(MAX_BLEND_DEPTH):
        row = mat_row(mats, mat_id)
        is_blend = row["kind"] == BLEND
        pick1 = u_levels[lvl] > row["blend_factor"]
        nxt = jnp.where(pick1, row["blend_m1"], row["blend_m2"])
        mat_id = jnp.where(is_blend, nxt, mat_id)
    return mat_id


def shading_normal_of(cs, mat_id, attrs, row=None):
    """Material-transformed normal: tangent-space normal map applied through
    the hit ONB (material/mod.rs:386-389); identity without a map. When no
    material in the scene carries a normal map this is the geometric normal
    exactly, so the texture fetch + ONB transform are skipped entirely.
    SoA: returns a component tuple."""
    if "normal_maps" not in cs.features:
        return attrs["normal"]
    ntex = (row or mat_row(cs.materials, mat_id))["normal_tex"]
    tc = sample_texture(cs.textures, ntex, attrs["uv"])
    tex_n = (tc[0] * 2.0 - 1.0, tc[1] * 2.0 - 1.0, tc[2] * 2.0 - 1.0)
    mapped = onb_local3(attrs["tangent"], attrs["bitangent"],
                        attrs["normal"], tex_n)
    return where3(ntex >= 0, mapped, attrs["normal"])


def scene_hit(cs: CompiledScene, o, d, pix, sample, bounce, seed):
    """world.hit equivalent: closest solid hit + constant-medium events.
    o, d are SoA component tuples. Returns (t, kind, idx) with
    kind=KIND_MEDIUM for volume scattering. Uses the flattened LBVH when
    the compiled scene carries one."""
    if cs.bvh is not None:
        # traversal kernel or XLA walk, chosen per platform
        # (ops/traverse.py:hit_path)
        t, kind, idx = traverse.closest_hit(cs, o, d, RAY_T_MIN, INF)
    else:
        t, kind, idx = closest_solid_hit(cs.solids, soa.to_aos(o),
                                         soa.to_aos(d), RAY_T_MIN, INF)
    if cs.media:
        o_a, d_a = soa.to_aos(o), soa.to_aos(d)
        for m_i, med in enumerate(cs.media):
            u = rng.uniform(pix, sample, bounce, _MEDIUM_PURPOSE_BASE + m_i,
                            seed)
            t_m = medium_hit(med, o_a, d_a, t, u)
            is_med = t_m < t
            t = jnp.where(is_med, t_m, t)
            kind = jnp.where(is_med, KIND_MEDIUM, kind)
            idx = jnp.where(is_med, m_i, idx)
    return t, kind, idx


def full_hit_attributes(cs, o, d, t, kind, idx, pix, sample, bounce, seed):
    """hit_attributes_soa + medium overrides (random phase normal, unit
    tangents, zero uv, back face, phase material —
    constant_medium.rs:63-74). o, d and returned vectors are SoA tuples."""
    attrs = hit_attributes_soa(cs.solids, o, d, t, kind, idx,
                               has_spheres="spheres" in cs.features)
    if cs.media:
        is_med = (kind == KIND_MEDIUM)
        r1, r2, _, _ = rng.uniform4(pix, sample, bounce, rng.P_PHASE, seed)
        phase_n = rng.unit_vector3(r1, r2)
        one = jnp.ones_like(t)
        ones = (one, one, one)
        med_mats = jnp.stack([m.mat for m in cs.media])
        m_idx = jnp.clip(idx, 0, len(cs.media) - 1)
        attrs["normal"] = where3(is_med, phase_n, attrs["normal"])
        attrs["tangent"] = where3(is_med, ones, attrs["tangent"])
        attrs["bitangent"] = where3(is_med, ones, attrs["bitangent"])
        attrs["uv"] = (jnp.where(is_med, 0.0, attrs["uv"][0]),
                       jnp.where(is_med, 0.0, attrs["uv"][1]))
        attrs["front_face"] = jnp.where(is_med, False, attrs["front_face"])
        attrs["mat"] = jnp.where(is_med, med_mats[m_idx], attrs["mat"])
    return attrs


# --- forward clamp-fold state (see module docstring) -----------------------
#
# Per-lane, per-channel state (A, B, dead) + per-lane outer_pdf flag; colors
# are (r, g, b) tuples of (R,) arrays (full-lane SoA, see geo/soa.py):
#   A         prefix product Π color_j·prob_j over scatter levels so far
#   B         running clamp bound min_i 3·A_{i-1} over pdf levels so far
#   dead      channel forced to 0 by a NaN filtered at a pdf level
#   outer_pdf True once any pdf level has been processed (an inner NaN will
#             be filtered by that outer level's f; shader.rs:109-125)

def fold_init(zero):
    """Identity fold state from a (R,) zero array (keeps mesh vary-ness)."""
    one = zero + 1.0
    big = zero + jnp.float32(INF)
    f = zero > 1.0
    return ((one, one, one), (big, big, big), (f, f, f), f)


def fold_scatter(state, color, prob, is_pdf, scat):
    """Fold one scatter level into (A, B, dead, outer_pdf) for lanes where
    ``scat`` is True. Exactly reproduces the reference's nested
    f(color·prob·L) recursion values (shader.rs:85-125) — see module
    docstring for the min-distribution identity."""
    A, B, dead, outer_pdf = state
    pdf_lvl = scat & is_pdf
    basic_lvl = scat & ~is_pdf
    nA, nB, nD = [], [], []
    for c in range(3):
        a = color[c] * prob
        nan_a = jnp.isnan(a)
        # pdf level: records its clamp bound 3·A_prev, filters its own NaNs
        nB.append(jnp.where(pdf_lvl, jnp.minimum(B[c], 3.0 * A[c]), B[c]))
        # basic level: its NaN is filtered by the nearest OUTER pdf level
        nD.append(dead[c] | (pdf_lvl & nan_a)
                  | (basic_lvl & nan_a & outer_pdf))
        nA.append(jnp.where(scat, A[c] * a, A[c]))
    return tuple(nA), tuple(nB), tuple(nD), outer_pdf | pdf_lvl


def fold_resolve(state, term_color):
    """Terminal color through the folded clamps: min(A·T, B), with a NaN
    terminal filtered by the innermost pdf level when one exists."""
    A, B, dead, outer_pdf = state
    out = []
    for c in range(3):
        dead_t = dead[c] | (jnp.isnan(term_color[c]) & outer_pdf)
        out.append(jnp.where(dead_t, 0.0,
                             jnp.minimum(A[c] * term_color[c], B[c])))
    return tuple(out)


def scatter(cs: CompiledScene, o, d, attrs, pix, sample, bounce, seed):
    """Material dispatch: compute scatter results for every material model
    and select per ray. All vectors/colors are SoA component tuples.
    Returns dict with is_emission, emit_color, atten, new_dir, tape_color,
    prob, is_pdf, shading_normal, is_basic."""
    mats = cs.materials

    if "blend" in cs.features:
        u_b = rng.uniform4(pix, sample, bounce, rng.P_BLEND_SCATTER, seed)
        eff = resolve_blend(mats, attrs["mat"], u_b)
        u_bn = rng.uniform4(pix, sample, bounce, rng.P_BLEND_NORMAL, seed)
        eff_n = resolve_blend(mats, attrs["mat"], u_bn)
        row = mat_row(mats, eff)
        row_n = mat_row(mats, eff_n)
    else:
        eff = eff_n = attrs["mat"]
        row = row_n = mat_row(mats, eff)
    s_normal = shading_normal_of(cs, eff_n, attrs, row=row_n)

    mk = row["kind"]
    albedo = sample_texture(cs.textures, row["albedo_tex"], attrs["uv"])
    albedo = tuple(c.astype(jnp.float32) for c in albedo)

    is_light = mk == DIFFUSE_LIGHT
    is_lamb = mk == LAMBERTIAN
    is_iso = mk == ISOTROPIC
    is_metal = mk == METAL
    is_diel = mk == DIELECTRIC
    is_pdf = is_lamb | is_iso

    # --- emission (material/mod.rs:359-368) ---
    emit_color = tuple(jnp.where(attrs["front_face"], c, 0.0)
                       for c in albedo)
    atten = row["atten"]

    # --- pdf-mixture scatter (material/mod.rs:191-207, 396-410) ---
    # static feature gates: materials kinds absent from the compiled scene
    # compile no code (closed-world specialization of the reference's
    # enum dispatch, material/mod.rs:134-150). Bit-identical: the skipped
    # selects would pick all-False branches.
    has_iso = "isotropic" in cs.features
    has_metal = "metal" in cs.features
    has_diel = "dielectric" in cs.features

    r1, r2, _, _ = rng.uniform4(pix, sample, bounce, rng.P_COSINE, seed)
    ct, cb, cn = onb_from_w3(s_normal)
    cos_dir = onb_local3(ct, cb, cn, rng.cosine_direction3(r1, r2))
    bsdf_dir = (where3(is_iso, rng.unit_vector3(r1, r2), cos_dir)
                if has_iso else cos_dir)

    n_lights = cs.lights.kind.shape[0]
    u_pick = rng.uniform(pix, sample, bounce, rng.P_LIGHT_PICK, seed)
    pick = jnp.minimum((u_pick * n_lights).astype(jnp.int32), n_lights - 1)
    l1, l2, _, _ = rng.uniform4(pix, sample, bounce, rng.P_LIGHT_SAMPLE, seed)
    light_dir = sample_light_direction3(cs.lights, attrs["point"], pick,
                                        l1, l2, kinds=cs.light_kinds)

    u_coin = rng.uniform(pix, sample, bounce, rng.P_MIX_COIN, seed)
    pdf_dir = where3(u_coin < 0.5, light_dir, bsdf_dir)

    light_val = light_pdf_mean3(cs.lights, attrs["point"], pdf_dir,
                                kinds=cs.light_kinds)
    unit_pdf_dir = unit3(pdf_dir)
    cos_value = jnp.maximum(dot3(unit_pdf_dir, unit3(s_normal)),
                            0.0) / jnp.pi
    sphere_value = 1.0 / (4.0 * jnp.pi)
    bsdf_val = (jnp.where(is_iso, sphere_value, cos_value)
                if has_iso else cos_value)
    mix_val = 0.5 * light_val + 0.5 * bsdf_val

    cos_sc = dot3(s_normal, unit_pdf_dir)
    lamb_sc = jnp.where(cos_sc < 0.0, 0.0, cos_sc / jnp.pi)
    scat_pdf = (jnp.where(is_iso, sphere_value, lamb_sc)
                if has_iso else lamb_sc)
    prob = scat_pdf / mix_val

    new_dir = pdf_dir
    if has_metal:
        # --- metal (material/mod.rs:239-249) ---
        f1, f2, f3, _ = rng.uniform4(pix, sample, bounce, rng.P_FUZZ, seed)
        reflected = reflect3(unit3(d), s_normal)
        metal_dir = soa.vadd(reflected,
                             vscale(rng.in_unit_sphere3(f1, f2, f3),
                                    row["fuzz"]))
        new_dir = where3(is_metal, metal_dir, new_dir)

    if has_diel:
        # --- dielectric (material/mod.rs:279-316) ---
        ior = row["ior"]
        rr = jnp.where(attrs["front_face"], 1.0 / ior, ior)
        udir = unit3(d)
        cos_t = jnp.minimum(dot3(vneg(udir), s_normal), 1.0)
        sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
        cannot = rr * sin_t > 1.0
        r0 = (1.0 - rr) / (1.0 + rr)
        r0 = r0 * r0
        reflectance = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
        u_d = rng.uniform(pix, sample, bounce, rng.P_DIELECTRIC, seed)
        diel_dir = where3(cannot | (reflectance > u_d),
                          reflect3(udir, s_normal),
                          refract3(udir, s_normal, rr))
        new_dir = where3(is_diel, diel_dir, new_dir)

    # Detached-sampling estimator: gradients flow through color/emission
    # values, never through sample directions or pdf weights (the
    # `probability = bsdf_pdf / mix_pdf` of material/mod.rs:202-206 is a
    # sampling artifact, not a differentiable quantity).
    new_dir = jax.lax.stop_gradient(new_dir)
    prob = jax.lax.stop_gradient(prob)

    return dict(
        is_emission=is_light,
        emit_color=emit_color,
        atten=atten,
        new_dir=new_dir,
        tape_color=albedo,
        prob=jnp.where(is_pdf, prob, 1.0),
        is_pdf=is_pdf,
        shading_normal=s_normal,
        is_basic=is_metal | is_diel,
    )


def bounce_step(cs: CompiledScene, carry, bounce, pix, sample, seed):
    """One wavefront bounce. Folds the scatter level into the clamp state.
    All vectors/colors in the carry are SoA component tuples."""
    (o, d, alive, acc_len, term_color, term_af, term_acc, fold) = carry

    t, kind, idx = scene_hit(cs, o, d, pix, sample, bounce, seed)
    miss = alive & ~jnp.isfinite(t)
    hit = alive & jnp.isfinite(t)
    t_safe = jnp.where(jnp.isfinite(t), t, 0.0)

    attrs = full_hit_attributes(cs, o, d, t_safe, kind, idx,
                                pix, sample, bounce, seed)
    sc = scatter(cs, o, d, attrs, pix, sample, bounce, seed)

    total_len = acc_len + t_safe  # shader.rs:74
    emit = hit & sc["is_emission"]
    scat = hit & ~sc["is_emission"]

    bg = cs.bg_color
    term_color = tuple(
        jnp.where(miss, bg[c], jnp.where(emit, sc["emit_color"][c],
                                         term_color[c]))
        for c in range(3))
    term_af = jnp.where(emit, sc["atten"], jnp.where(miss, 0.0, term_af))
    term_acc = jnp.where(emit, total_len, term_acc)

    new_o = where3(scat, attrs["point"], o)
    new_d = where3(scat, sc["new_dir"], d)
    new_alive = alive & ~miss & ~emit
    new_acc = jnp.where(hit, total_len, acc_len)

    fold = fold_scatter(fold, sc["tape_color"], sc["prob"], sc["is_pdf"],
                        scat)
    return (new_o, new_d, new_alive, new_acc, term_color, term_af,
            term_acc, fold)


def camera_rays(cs: CompiledScene, pix, width, height, sample, seed):
    """Jittered thin-lens primary rays (renderer/mod.rs:262-265,
    camera.rs:77-89) for an arbitrary batch of pixel ids, in SoA form.
    Pixel (x, y) uses v-up convention; the image row is height-1-y
    (renderer/mod.rs:261)."""
    x = (pix % width).astype(jnp.float32)
    y = (pix // width).astype(jnp.float32)
    j1, j2, _, _ = rng.uniform4(pix, sample, 0, rng.P_JITTER, seed)
    u = (x + j1) / (width - 1)
    v = (y + j2) / (height - 1)

    cam = cs.camera
    l1, l2, _, _ = rng.uniform4(pix, sample, 0, rng.P_LENS, seed)
    rd = rng.in_unit_disc3(l1, l2)
    rd0 = rd[0] * cam.lens_radius
    rd1 = rd[1] * cam.lens_radius
    use_lens = cam.lens_radius > 0.0
    origin = []
    direction = []
    for c in range(3):
        off = jnp.where(use_lens, cam.u[c] * rd0 + cam.v[c] * rd1, 0.0)
        origin.append(cam.origin[c] + off)
        direction.append(cam.lower_left[c] + cam.horizontal[c] * u
                         + cam.vertical[c] * v - cam.origin[c] - off)
    return pix, tuple(origin), tuple(direction)


def trace(cs: CompiledScene, o, d, pix, sample, seed, max_depth,
          early_exit=True):
    """Full path trace of a ray wavefront → linear color (R, 3). o, d are
    SoA component tuples.

    early_exit=True runs a while_loop that stops once every ray has
    terminated (the common case is ≤5 bounces of a 50 cap) — the wavefront
    analogue of the reference's recursion simply returning. The scan variant
    (early_exit=False) has a fixed trip count and is reverse-differentiable
    (used by the diff module as the path-replay backward).
    """
    # derive the init state from o so every carry component is varying over
    # any shard_map mesh axes the inputs are varying over
    zero = o[0] * 0.0
    carry = (o, d,
             zero == zero,          # alive (all True)
             zero,                  # accumulated ray length
             (zero, zero, zero),    # terminal color
             zero,                  # terminal attenuation factor
             zero,                  # terminal accumulated length
             fold_init(zero))

    if early_exit:
        def cond(state):
            bounce, carry = state
            return (bounce < max_depth) & jnp.any(carry[2])

        def body(state):
            bounce, carry = state
            carry = bounce_step(cs, carry, bounce, pix, sample, seed)
            return bounce + 1, carry

        _, carry = jax.lax.while_loop(cond, body, (jnp.int32(0), carry))
    else:
        # Reverse-differentiable bounce loop with MEMORY-BOUNDED backward:
        # a two-level scan with the inner chunk rematerialized
        # (jax.checkpoint). Reverse-mode stores only the ~23 floats/lane
        # carry at the n_outer chunk boundaries and replays each chunk's
        # bounces from its boundary carry during the backward sweep — the
        # path-replay backward (counter-based RNG makes the replay draw the
        # identical sampling decisions). A flat scan tape would hold every
        # bounce's full wavefront intermediates (O(depth·R) — OOM at
        # 300x200 @ depth 50).
        chunk = max((k for k in range(1, max_depth + 1)
                     if max_depth % k == 0 and k * k <= max_depth * 2),
                    default=1)
        n_outer = max_depth // chunk

        @jax.checkpoint
        def inner(carry, bounce0):
            def step(carry, j):
                return bounce_step(cs, carry, bounce0 + j, pix, sample,
                                   seed), None

            carry, _ = jax.lax.scan(step, carry, jnp.arange(chunk))
            return carry

        def outer_step(carry, i):
            return inner(carry, i * chunk), None

        carry, _ = jax.lax.scan(outer_step, carry,
                                jnp.arange(n_outer, dtype=jnp.int32))
    o_f, d_f, alive, _, term_color, term_af, term_acc, fold = carry

    # Depth-cap resolution (renderer/mod.rs:164-206 at depth == max_depth):
    # a still-alive ray that hits something shades to black (shader.rs:70-72),
    # a miss still returns the background color.
    def cap(args):
        o_f, d_f, alive, term_color, term_af = args
        t, _, _ = scene_hit(cs, o_f, d_f, pix, sample, max_depth, seed)
        final_miss = alive & ~jnp.isfinite(t)
        term_color = tuple(jnp.where(final_miss, cs.bg_color[c],
                                     term_color[c]) for c in range(3))
        term_af = jnp.where(final_miss, 0.0, term_af)
        return term_color, term_af

    term_color, term_af = jax.lax.cond(
        jnp.any(alive), cap, lambda args: (args[3], args[4]),
        (o_f, d_f, alive, term_color, term_af))

    color = fold_resolve(fold, term_color)
    # top-level get_attenuated_color (material/mod.rs:124-132)
    att = jnp.where(term_af > 0.0,
                    1.0 / (1.0 + term_af * term_acc), 1.0)
    return soa.to_aos(tuple(c * att for c in color))


def first_hit_aux(cs: CompiledScene, o, d, pix, sample, seed):
    """Albedo + normal aux channels at depth 0 (renderer/mod.rs:175-189 with
    the reference's flag-inversion bug fixed per SURVEY §3): albedo = scatter
    color, normal = shading normal; background/zero on miss. SoA in,
    (R, 3) out."""
    t, kind, idx = scene_hit(cs, o, d, pix, sample, 0, seed)
    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 0.0)
    attrs = full_hit_attributes(cs, o, d, t_safe, kind, idx, pix, sample, 0,
                                seed)
    sc = scatter(cs, o, d, attrs, pix, sample, 0, seed)
    albedo = soa.to_aos(tuple(
        jnp.where(hit,
                  jnp.where(sc["is_emission"], sc["emit_color"][c],
                            sc["tape_color"][c]),
                  cs.bg_color[c]) for c in range(3)))
    normal = soa.to_aos(tuple(jnp.where(hit, sc["shading_normal"][c], 0.0)
                              for c in range(3)))
    return albedo, normal


# --- single-bounce debug shaders (shader.rs:127-215) ----------------------

def shade_albedo(cs, o, d, pix, sample, seed):
    albedo, _ = first_hit_aux(cs, o, d, pix, sample, seed)
    return albedo


def shade_normal(cs, o, d, pix, sample, seed):
    t, kind, idx = scene_hit(cs, o, d, pix, sample, 0, seed)
    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 0.0)
    attrs = full_hit_attributes(cs, o, d, t_safe, kind, idx, pix, sample, 0,
                                seed)
    u_bn = rng.uniform4(pix, sample, 0, rng.P_BLEND_NORMAL, seed)
    eff_n = resolve_blend(cs.materials, attrs["mat"], u_bn, cs.features)
    normal = shading_normal_of(cs, eff_n, attrs)
    return soa.to_aos(tuple(jnp.where(hit, normal[c], cs.bg_color[c])
                            for c in range(3)))


def shade_simple(cs, o, d, pix, sample, seed):
    """Flat shading: emission color, or albedo × (n·l·0.5+0.75) with
    l = (1,1,-1) (shader.rs:191-215)."""
    t, kind, idx = scene_hit(cs, o, d, pix, sample, 0, seed)
    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 0.0)
    attrs = full_hit_attributes(cs, o, d, t_safe, kind, idx, pix, sample, 0,
                                seed)
    sc = scatter(cs, o, d, attrs, pix, sample, 0, seed)
    n = sc["shading_normal"]
    factor = (n[0] * 1.0 + n[1] * 1.0 + n[2] * -1.0) * 0.5 + 0.75
    return soa.to_aos(tuple(
        jnp.where(hit,
                  jnp.where(sc["is_emission"], sc["emit_color"][c],
                            sc["tape_color"][c] * factor),
                  cs.bg_color[c]) for c in range(3)))


SHADER_PATH = 0
SHADER_ALBEDO = 1
SHADER_NORMAL = 2
SHADER_SIMPLE = 3


def render_pixels(cs: CompiledScene, pix, sample, seed, *, width, height,
                  max_depth, shader_kind, need_aux, early_exit=True):
    """Render an arbitrary wavefront of pixel ids → (color, albedo, normal)
    linear colors of shape (R, 3). This is the sharding unit: pixel ids are
    the only per-ray input, and the counter-based RNG keys off them, so any
    tile/row partition of the id space renders bit-identically."""
    _, o, d = camera_rays(cs, pix, width, height, sample, seed)
    if shader_kind == SHADER_PATH:
        color = trace(cs, o, d, pix, sample, seed, max_depth,
                      early_exit=early_exit)
    elif shader_kind == SHADER_ALBEDO:
        color = shade_albedo(cs, o, d, pix, sample, seed)
    elif shader_kind == SHADER_NORMAL:
        color = shade_normal(cs, o, d, pix, sample, seed)
    else:
        color = shade_simple(cs, o, d, pix, sample, seed)

    if need_aux:
        albedo, normal = first_hit_aux(cs, o, d, pix, sample, seed)
    else:
        albedo = jnp.zeros_like(color)
        normal = jnp.zeros_like(color)
    return color, albedo, normal


@partial(jax.jit, static_argnames=("width", "height", "max_depth",
                                   "shader_kind", "need_aux"))
def render_sample(cs: CompiledScene, sample, seed, *, width, height,
                  max_depth, shader_kind, need_aux):
    """Render ONE full-image sample pass → (pixel, albedo, normal) linear
    color planes of shape (height, width, 3), image-row order (top row
    first, renderer/mod.rs:261)."""
    pix = jnp.arange(width * height, dtype=jnp.int32)
    color, albedo, normal = render_pixels(
        cs, pix, sample, seed, width=width, height=height,
        max_depth=max_depth, shader_kind=shader_kind, need_aux=need_aux)

    def to_image(c):
        return c.reshape(height, width, 3)[::-1]

    return to_image(color), to_image(albedo), to_image(normal)


def trace_queued(cs: CompiledScene, pix_ids, sample_start, n_samples, seed,
                 *, width, height, max_depth, lanes=None, n_valid=None):
    """Work-queue wavefront: a fixed pool of lanes drains the global
    (pixel, sample) queue. When paths terminate, the terminating lanes claim
    the next assignments in pixel-major order (rank via cumsum); terminated
    paths resolve their clamp-fold and scatter-add into the image. Unlike
    per-pixel lanes, no lane ever idles waiting for a slow pixel —
    occupancy stays near 100% until the queue drains.

    pix_ids: (Np,) pixel ids this call owns (a shard or the full image), or
    None for the full image (pixel id == queue slot — skips a 32k-wide
    gather per iteration). n_valid (optional, may be traced): only the
    first n_valid entries of pix_ids are real work — sharded callers pad
    their last shard with duplicate ids and exclude them here so segment
    counts (and Mrays/s derived from them) stay exact.
    Returns (accum (Np, 3) summed over n_samples, segments traced).

    Every while-iteration pays a fixed cost (several kernel launches plus
    the loop predicate's device-to-host read), so more lanes mean fewer
    iterations; the drain tail is handled by the compaction below.
    """
    n_pix = width * height if pix_ids is None else pix_ids.shape[0]
    nv = n_pix if n_valid is None else n_valid
    total_q = nv * n_samples  # queue length (python int or traced scalar)
    if lanes is None:
        # Fewer lanes make every iteration cheaper; more lanes mean fewer
        # full-occupancy iterations. The drain tail (up to max_depth
        # near-empty iterations while the deepest paths finish) costs
        # per-iteration regardless, so small queues take half-size pools.
        lanes = 131072 if n_pix * n_samples >= 1_500_000 else 65536
        lanes = min(lanes, n_pix * n_samples)

    # Tile-swizzled full-image order: consecutive queue slots cover a
    # (tile_w x tile_h) screen tile instead of a scanline, so neighbouring
    # lanes (a warp in the traversal kernel) trace spatially compact rays
    # that walk similar tree paths. Pure arithmetic bijection; per-pixel
    # RNG keys off the pixel id, so the image is bit-identical to scanline
    # order.
    swz = None
    if pix_ids is None:
        for tw, th in ((32, 32), (32, 16), (32, 8), (32, 4), (64, 2)):
            if width % tw == 0 and height % th == 0:
                swz = (tw, th)
                break

    def swizzle(pslot):
        if swz is None:
            return pslot
        tw, th = swz
        tile, within = pslot // (tw * th), pslot % (tw * th)
        tx, ty = tile % (width // tw), tile // (width // tw)
        return (ty * th + within // tw) * width + tx * tw + within % tw

    zero_l = jnp.zeros((lanes,), jnp.float32)

    def assignment(qpos):
        """queue position → (pixel id, accum slot, sample id)."""
        pslot = qpos % nv
        samp = sample_start + qpos // nv
        if pix_ids is None:
            pixel = swizzle(pslot)
            return pixel, pixel, samp
        return pix_ids[pslot], pslot, samp

    def cam_rays(pixel, sample_arr):
        x = (pixel % width).astype(jnp.float32)
        y = (pixel // width).astype(jnp.float32)
        j1, j2, _, _ = rng.uniform4(pixel, sample_arr, 0, rng.P_JITTER, seed)
        u = (x + j1) / (width - 1)
        v = (y + j2) / (height - 1)
        cam = cs.camera
        l1, l2, _, _ = rng.uniform4(pixel, sample_arr, 0, rng.P_LENS, seed)
        rd = rng.in_unit_disc3(l1, l2)
        rd0 = rd[0] * cam.lens_radius
        rd1 = rd[1] * cam.lens_radius
        use_lens = cam.lens_radius > 0.0
        o = []
        d = []
        for c in range(3):
            off = jnp.where(use_lens, cam.u[c] * rd0 + cam.v[c] * rd1, 0.0)
            o.append(cam.origin[c] + off)
            d.append(cam.lower_left[c] + cam.horizontal[c] * u
                     + cam.vertical[c] * v - cam.origin[c] - off)
        return tuple(o), tuple(d)

    qpos0 = jnp.arange(lanes, dtype=jnp.int32)
    pixel0, pslot0, sample0 = assignment(jnp.minimum(qpos0, total_q - 1))
    o0, d0 = cam_rays(pixel0, sample0)
    # lanes beyond the queue (short sharded queues) start parked: zero
    # direction so intersection kernels skip them (see parked note below)
    d0 = tuple(jnp.where(qpos0 >= total_q, 0.0, c) for c in d0)

    state = dict(
        qpos=qpos0,                    # queue position per lane
        bounce=jnp.zeros((lanes,), jnp.int32),
        o=o0, d=d0,
        acc_len=zero_l,
        fold=fold_init(zero_l),
        next_q=jnp.int32(lanes),       # next unclaimed queue position
        # (n_pix, 3) accumulator: ONE row-scatter per iteration
        accum=jnp.zeros((n_pix, 3), jnp.float32),
        segments=jnp.float32(0.0),
    )

    # Two-phase drain tail: once the queue is fully claimed the loop only
    # drains in-flight deep paths — occupancy collapses (the kitchen-sink
    # bench spends ~55 of 69 iterations below ~15%), but every iteration
    # still pays full-width sort/sweep/scatter glue. When the live count
    # falls to lanes/8, the surviving rays are COMPACTED into a pool an
    # eighth the width and the drain finishes there at ~1/8 the
    # per-iteration cost. Same paths, same RNG draws, same segment count;
    # only scatter-add collision order can differ (fp reassociation, the
    # tolerance the sharding tests already grant).
    tail_lanes = lanes // 8 if lanes >= 32768 else 0

    def cond(state):
        return jnp.any(state["qpos"] < total_q)

    def cond_wide(state):
        active = state["qpos"] < total_q
        live = jnp.sum(active.astype(jnp.int32))
        return (state["next_q"] < total_q) | (live > tail_lanes)

    def body(state):
        qpos = state["qpos"]
        pixel, pslot, sample = assignment(jnp.minimum(qpos, total_q - 1))
        o, d = state["o"], state["d"]
        bounce = state["bounce"]
        active = qpos < total_q

        t, kind, idx = scene_hit(cs, o, d, pixel, sample, bounce, seed)
        finite = jnp.isfinite(t)
        miss = active & ~finite
        t_safe = jnp.where(finite, t, 0.0)
        attrs = full_hit_attributes(cs, o, d, t_safe, kind, idx, pixel,
                                    sample, bounce, seed)
        sc = scatter(cs, o, d, attrs, pixel, sample, bounce, seed)

        capped = active & finite & (bounce >= max_depth)
        emit = active & finite & ~capped & sc["is_emission"]
        scat = active & finite & ~capped & ~sc["is_emission"]
        terminal = miss | capped | emit

        total_len = state["acc_len"] + t_safe
        term_color = tuple(
            jnp.where(miss, cs.bg_color[c],
                      jnp.where(emit, sc["emit_color"][c], 0.0))
            for c in range(3))
        term_af = jnp.where(emit, sc["atten"], 0.0)
        term_acc = jnp.where(emit, total_len, 0.0)

        L = fold_resolve(state["fold"], term_color)
        att = jnp.where(term_af > 0.0, 1.0 / (1.0 + term_af * term_acc), 1.0)
        updates = jnp.stack(
            [jnp.where(terminal, L[c] * att, 0.0) for c in range(3)], -1)
        accum = state["accum"].at[pslot].add(updates)

        # fold this bounce's scatter level; reset regenerated lanes
        A, B, dead, outer = fold_scatter(state["fold"], sc["tape_color"],
                                         sc["prob"], sc["is_pdf"], scat)
        fold = (tuple(jnp.where(terminal, 1.0, A[c]) for c in range(3)),
                tuple(jnp.where(terminal, INF, B[c]) for c in range(3)),
                tuple(jnp.where(terminal, False, dead[c]) for c in range(3)),
                jnp.where(terminal, False, outer))

        # terminal lanes claim the next queue slots (rank by cumsum)
        term_i = terminal.astype(jnp.int32)
        rank = jnp.cumsum(term_i) - term_i  # exclusive prefix
        new_qpos = jnp.where(terminal, state["next_q"] + rank, qpos)
        next_q = state["next_q"] + jnp.sum(term_i)

        npixel, _, nsample = assignment(jnp.minimum(new_qpos, total_q - 1))
        o_new, d_new = cam_rays(npixel, nsample)
        # Parked lanes (queue exhausted) get a ZERO direction instead of a
        # duplicate pixel's real ray: the traversal then rejects them
        # at the first slab test (1/0 -> inf/NaN comparisons) so the drain
        # tail — up to max_depth iterations in which only the few deepest
        # paths are still alive — costs ~nothing per dead lane instead of a
        # full traversal whose result is discarded.
        parked = new_qpos >= total_q
        d_new = tuple(jnp.where(parked, 0.0, c) for c in d_new)
        o2 = where3(terminal, o_new, where3(scat, attrs["point"], o))
        d2 = where3(terminal, d_new, where3(scat, sc["new_dir"], d))
        bounce2 = jnp.where(terminal, 0, jnp.where(scat, bounce + 1, bounce))
        acc2 = jnp.where(terminal, 0.0,
                         jnp.where(scat, total_len, state["acc_len"]))

        return dict(qpos=new_qpos, bounce=bounce2, o=o2, d=d2,
                    acc_len=acc2, fold=fold, next_q=next_q, accum=accum,
                    segments=state["segments"]
                    + jnp.sum(active.astype(jnp.float32)))

    if tail_lanes:
        state = jax.lax.while_loop(cond_wide, body, state)
        # compact live lanes (alive-first stable order) into the tail pool
        active = state["qpos"] < total_q

        def sub(v):
            perm = jnp.argsort(jnp.where(active, 0, 1))[:tail_lanes]
            return v[perm]

        state_b = dict(state)
        for k in ("qpos", "bounce", "acc_len"):
            state_b[k] = sub(state[k])
        state_b["o"] = tuple(sub(c) for c in state["o"])
        state_b["d"] = tuple(sub(c) for c in state["d"])
        A, B, dead, outer = state["fold"]
        state_b["fold"] = (tuple(sub(c) for c in A),
                           tuple(sub(c) for c in B),
                           tuple(sub(c) for c in dead), sub(outer))
        state = jax.lax.while_loop(cond, body, state_b)
    else:
        state = jax.lax.while_loop(cond, body, state)
    return state["accum"], state["segments"]


@partial(jax.jit, static_argnames=("width", "height", "max_depth",
                                   "shader_kind", "need_aux", "n_samples"))
def render_sample_batch(cs: CompiledScene, sample_start, seed, *, width,
                        height, max_depth, shader_kind, need_aux, n_samples):
    """Accumulate n_samples consecutive sample passes in ONE device program.
    The path-tracing shader uses the regenerative wavefront; debug shaders
    and aux channels loop per sample. Returns summed (pixel, albedo, normal)
    planes plus the traced-segment count (perf telemetry)."""
    pix = jnp.arange(width * height, dtype=jnp.int32)
    zero = jnp.zeros((width * height, 3), jnp.float32)

    if shader_kind == SHADER_PATH:
        color, segments = trace_queued(
            cs, None, sample_start, n_samples, seed, width=width,
            height=height, max_depth=max_depth)
    else:
        def body(i, acc):
            c, _, _ = render_pixels(
                cs, pix, sample_start + i, seed, width=width, height=height,
                max_depth=max_depth, shader_kind=shader_kind, need_aux=False)
            return acc + c

        color = jax.lax.fori_loop(0, n_samples, body, zero)
        segments = jnp.float32(width * height * n_samples)

    if need_aux:
        def aux_body(i, acc):
            _, oo, dd = camera_rays(cs, pix, width, height, sample_start + i,
                                    seed)
            albedo, normal = first_hit_aux(cs, oo, dd, pix, sample_start + i,
                                           seed)
            return (acc[0] + albedo, acc[1] + normal)

        albedo, normal = jax.lax.fori_loop(0, n_samples, aux_body,
                                           (zero, zero))
    else:
        albedo = zero
        normal = zero

    def to_image(c):
        return c.reshape(height, width, 3)[::-1]

    return to_image(color), to_image(albedo), to_image(normal), segments
