"""Fixture scenes mirroring the reference golden suite
(``/root/reference/tests/scenes.rs``) — same geometry, materials, cameras.

Image textures are generated from fixed seeds (numpy only, no image
files): an albedo, a tangent-space normal map made from a height field
through ``height_to_normal_map``, a checker and a height map, at the size
class of the reference's texture assets."""
from __future__ import annotations

import functools

import numpy as np

from solstrale import (Blend, Bvh, CameraConfig, ConstantMedium,
                       Dielectric, DiffuseLight, ImageMap, Lambertian,
                       Metal, NopTransformer, Quad, RotationY, Scene,
                       SolidColor, Sphere, Transformations, Translation,
                       Triangle, new_box)
from solstrale.utils import height_to_normal_map

REF = "/root/reference"


def _smooth_noise(rng, h, w, cell):
    """(h, w) field in [0, 1]: a random (h/cell, w/cell) grid bilinearly
    upsampled, plus a finer octave."""
    def octave(c):
        gh, gw = h // c + 2, w // c + 2
        g = rng.random((gh, gw))
        ys = np.arange(h) / c
        xs = np.arange(w) / c
        y0, x0 = ys.astype(int), xs.astype(int)
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        a = g[y0][:, x0]
        b = g[y0][:, x0 + 1]
        c_ = g[y0 + 1][:, x0]
        d = g[y0 + 1][:, x0 + 1]
        return (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
                + c_ * (1 - fx) * fy + d * fx * fy)

    return 0.7 * octave(cell) + 0.3 * octave(max(cell // 8, 1))


@functools.lru_cache(maxsize=None)
def height_image(seed=11, h=512, w=1024):
    """Grayscale height map, (h, w, 3) u8."""
    v = _smooth_noise(np.random.default_rng(seed), h, w, 64)
    g = (v * 255.0).astype(np.uint8)
    return np.repeat(g[..., None], 3, axis=2)


@functools.lru_cache(maxsize=None)
def albedo_texture(seed=5, size=1024):
    """Colored albedo (stone-like blotches), 1024x1024."""
    rng = np.random.default_rng(seed)
    v = _smooth_noise(rng, size, size, 128)
    base = np.array([0.62, 0.52, 0.40])
    tint = np.array([0.25, 0.22, 0.18])
    img = base + (v[..., None] - 0.5) * tint * 2.0
    img = img + 0.04 * rng.standard_normal((size, size, 3))
    return ImageMap((np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8))


@functools.lru_cache(maxsize=None)
def ground_texture(seed=3, size=1024):
    """Second albedo (green-brown ground), 1024x1024."""
    rng = np.random.default_rng(seed)
    v = _smooth_noise(rng, size, size, 96)
    img = np.stack([0.30 + 0.35 * v, 0.45 + 0.25 * v, 0.20 + 0.15 * v], -1)
    return ImageMap((np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8))


@functools.lru_cache(maxsize=None)
def normal_texture(seed=7, size=1024):
    """Tangent-space normal map from a seeded height field, 1024x1024."""
    v = _smooth_noise(np.random.default_rng(seed), size, size, 32)
    g = np.repeat((v * 255.0).astype(np.uint8)[..., None], 3, axis=2)
    return ImageMap(height_to_normal_map(g))


@functools.lru_cache(maxsize=None)
def height_normal_texture(seed=11):
    """The height map of ``height_image`` as a normal map (the conversion
    load_normal_texture applies to height maps, texture.rs:89-97)."""
    return ImageMap(height_to_normal_map(height_image(seed)))


@functools.lru_cache(maxsize=None)
def height_albedo_texture(seed=11):
    """The height map itself used as an albedo."""
    return ImageMap(height_image(seed))


@functools.lru_cache(maxsize=None)
def checker_texture(size=512, squares=8):
    """Black/white checker, 512x512."""
    k = (np.arange(size) * squares // size)
    cell = (k[:, None] + k[None, :]) % 2
    g = np.where(cell == 0, 255, 0).astype(np.uint8)
    return ImageMap(np.repeat(g[..., None], 3, axis=2))


def create_test_scene(render_config):
    """Kitchen-sink scene (scenes.rs:17-122): quads, glass sphere, boxes,
    constant medium, triangle grid, three light types."""
    camera = CameraConfig(vertical_fov_degrees=20.0, aperture_size=0.1,
                          look_from=(-5.0, 3.0, 6.0), look_at=(0.25, 1.0, 0.0))
    world = []
    ground = Lambertian(ground_texture())
    glass = Dielectric(SolidColor(1.0, 1.0, 1.0), None, 1.5)
    light = DiffuseLight(10.0, 10.0, 10.0)
    red = Lambertian(SolidColor(1.0, 0.0, 0.0))

    world.append(Quad((-5, 0, -15), (20, 0, 0), (0, 0, 20), ground))
    world.append(Sphere((-1, 1, 0), 1.0, glass))
    world += new_box((0, 0, -0.5), (1, 2, 0.5), red, RotationY(15.0))
    world.append(ConstantMedium(
        Bvh(new_box((0, 0, -0.5), (1, 2, 0.5), red, Translation((0, 0, 1)))),
        0.1, (1, 1, 1)))
    world += new_box((-1, 2, 0), (-0.5, 2.5, 0.5), red)

    balls = []
    for ii in range(0, 10, 2):
        i = ii * 0.1
        for jj in range(0, 10, 2):
            j = jj * 0.1
            for kk in range(0, 10, 2):
                k = kk * 0.1
                balls.append(Triangle((i, j + 0.05, k + 0.8), (i, j, k + 0.8),
                                      (i, j + 0.05, k), red))
    world.append(Bvh(balls))
    world.append(Triangle((1, 0.1, 2), (3, 0.1, 2), (2, 0.1, 1), red))

    # lights
    world.append(Sphere((10, 5, 10), 10.0, light))
    world.append(Quad((0, 0, 0), (2, 0, 0), (0, 0, 2), light,
                      Transformations([RotationY(45.0),
                                       Translation((-1, 10, -1))])))
    world.append(Triangle((-2, 1, -3), (0, 1, -3), (-1, 2, -3), light))

    return Scene(Bvh(world), camera, (0.2, 0.3, 0.5), render_config)


def new_bvh_test_scene(render_config, use_bvh, num_triangles):
    """Parameterized triangle-row scene (scenes.rs:125-167)."""
    camera = CameraConfig(vertical_fov_degrees=20.0, aperture_size=0.1,
                          look_from=(-0.5, 0.0, 4.0), look_at=(-0.5, 0.0, 0.0))
    world = [Sphere((0, 4, 10), 4.0, DiffuseLight(10.0, 10.0, 10.0))]
    yellow = Lambertian(SolidColor(1.0, 1.0, 0.0))
    tris = []
    for x in range(num_triangles):
        cx = x - num_triangles / 2.0
        t = Triangle((cx, -0.5, 0), (cx + 1, -0.5, 0), (cx + 0.5, 0.5, 0), yellow)
        (tris if use_bvh else world).append(t)
    if use_bvh:
        world.append(Bvh(tris))
    return Scene(Bvh(world), camera, (0.2, 0.3, 0.5), render_config)


def create_simple_test_scene(render_config, add_light=True):
    """One sphere + one sphere light (scenes.rs:170-193)."""
    camera = CameraConfig(vertical_fov_degrees=20.0, aperture_size=0.1,
                          look_from=(0.0, 0.0, 4.0), look_at=(0.0, 0.0, 0.0))
    world = []
    if add_light:
        world.append(Sphere((0, 100, 0), 20.0, DiffuseLight(10.0, 10.0, 10.0)))
    world.append(Sphere((0, 0, 0), 0.5, Lambertian(SolidColor(1.0, 1.0, 0.0))))
    return Scene(Bvh(world), camera, (0.2, 0.3, 0.5), render_config)


def create_uv_scene(render_config):
    """Wrapping/negative UV triangle (scenes.rs:196-230)."""
    camera = CameraConfig(vertical_fov_degrees=20.0, aperture_size=0.0,
                          look_from=(0.0, 1.0, 5.0), look_at=(0.0, 1.0, 0.0))
    world = [Sphere((50, 50, 50), 20.0, DiffuseLight(10.0, 10.0, 10.0))]
    checker = Lambertian(checker_texture())
    world.append(Triangle.new_with_tex_coords(
        (-1, 0, 0), (1, 0, 0), (0, 2, 0),
        (-1, -1), (2, -1), (0, 2), checker))
    return Scene(Bvh(world), camera, (0.2, 0.3, 0.5), render_config)


def create_normal_mapping_scene(render_config, light_pos, enabled):
    """Quad with wall normal map (scenes.rs:233-280)."""
    camera = CameraConfig(vertical_fov_degrees=40.0, aperture_size=0.0,
                          look_from=(0.2, 0.2, 2.0), look_at=(0.0, 0.0, 0.0))
    world = [Sphere(light_pos, 5.0, DiffuseLight(45.0, 45.0, 45.0))]
    normal_tex = normal_texture() if enabled else None
    mat = Lambertian(SolidColor(0.8, 0.8, 0.8), normal_tex)
    red = Lambertian(SolidColor(1.0, 0.0, 0.0))
    world += new_box((-0.1, -0.1, 0), (0.1, 0.1, 1), red)
    world.append(Quad((-1, -1, 0), (2, 0, 0), (0, 2, 0), mat))
    return Scene(Bvh(world), camera, (0.0, 0.0, 0.0), render_config)


def create_normal_mapping_sphere_scene(render_config, light_pos):
    """Sphere with earth height map as bump (scenes.rs:283-315)."""
    camera = CameraConfig(vertical_fov_degrees=40.0, aperture_size=0.0,
                          look_from=(0.2, 0.2, 2.0), look_at=(0.0, 0.0, 0.0))
    world = [Sphere(light_pos, 5.0, DiffuseLight(45.0, 45.0, 45.0))]
    mat = Lambertian(SolidColor(0.8, 0.8, 0.8), height_normal_texture())
    world.append(Sphere((0, 0, 0), 0.6, mat))
    return Scene(Bvh(world), camera, (0.0, 0.0, 0.0), render_config)


def create_obj_scene(render_config):
    """Spider OBJ with textures (scenes.rs:318-352)."""
    from solstrale.scene.loader import Obj

    camera = CameraConfig(vertical_fov_degrees=30.0, aperture_size=20.0,
                          look_from=(-250.0, 30.0, 150.0),
                          look_at=(-50.0, 0.0, 0.0))
    world = [Sphere((-100, 100, 40), 35.0, DiffuseLight(15.0, 15.0, 15.0))]
    world.append(Obj(f"{REF}/resources/spider/", "spider.obj")
                 .load(NopTransformer(), None))
    ground = Lambertian(ground_texture())
    world.append(Quad((-200, -30, -200), (400, 0, 0), (0, 0, 400), ground))
    return Scene(Bvh(world), camera, (0.2, 0.3, 0.5), render_config)


def create_obj_with_box(render_config, path, filename):
    """Box OBJ with default/diffuse material (scenes.rs:355-381)."""
    from solstrale.scene.loader import Obj

    camera = CameraConfig(vertical_fov_degrees=30.0, aperture_size=0.0,
                          look_from=(2.0, 1.0, 3.0), look_at=(0.0, 0.0, 0.0))
    world = [Sphere((-100, 100, 40), 35.0, DiffuseLight(15.0, 15.0, 15.0))]
    red = Lambertian(SolidColor(1.0, 0.0, 0.0))
    world.append(Obj(path, filename).load(NopTransformer(), red))
    return Scene(Bvh(world), camera, (0.2, 0.3, 0.5), render_config)


def create_obj_with_triangle(render_config, path, filename):
    """Triangle OBJ with normal/height bump map (scenes.rs:384-409)."""
    from solstrale.scene.loader import Obj

    camera = CameraConfig(vertical_fov_degrees=30.0, aperture_size=0.0,
                          look_from=(0.0, 0.0, 2.0), look_at=(0.0, 0.0, 0.0))
    world = [Sphere((100, 0, 100), 35.0, DiffuseLight(15.0, 15.0, 15.0))]
    world.append(Obj(path, filename).load(NopTransformer(), None))
    return Scene(Bvh(world), camera, (0.0, 0.0, 0.0), render_config)


def create_light_attenuation_scene(render_config, attenuation_half_length):
    """Small light + spheres on a red quad (scenes.rs:412-449)."""
    camera = CameraConfig(vertical_fov_degrees=20.0, aperture_size=0.0,
                          look_from=(0.0, 1.0, 2.0), look_at=(0.0, 0.2, 0.0))
    light = DiffuseLight(25.0, 25.0, 25.0,
                         attenuation_half_length=attenuation_half_length)
    world = [
        Sphere((0, 0.2, 0), 0.03, light),
        Sphere((0.25, 0.1, 0.25), 0.1, Lambertian(SolidColor(0, 1, 0))),
        Sphere((0.25, 0.1, -0.5), 0.1, Lambertian(SolidColor(0, 0, 1))),
        Sphere((-0.1, 0.1, -0.1), 0.1,
               Dielectric(SolidColor(0.8, 0.8, 0.8), None, 1.5)),
        Quad((-1, 0, -1), (2, 0, 0), (0, 0, 2),
             Lambertian(SolidColor(1, 0, 0))),
    ]
    return Scene(Bvh(world), camera, (0.0, 0.0, 0.0), render_config)


def create_quad_rotation_scene(render_config, rotation):
    """Rotated ground quad under a sphere light (scenes.rs:452-479)."""
    world = [
        Quad((-100, 0, -100), (200, 0, 0), (0, 0, 200),
             Lambertian(SolidColor(0, 1, 0)), rotation),
        Sphere((100, 300, -500), 50.0, DiffuseLight(15.0, 15.0, 15.0)),
    ]
    camera = CameraConfig(vertical_fov_degrees=35.0,
                          look_from=(0.0, 200.0, -500.0))
    return Scene(Bvh(world), camera, (0.0, 0.0, 0.0), render_config)


def create_blend_material_scene(render_config, blend_factor):
    """Checker/green blend ground (scenes.rs:482-513)."""
    world = [
        Quad((-100, 0, -100), (200, 0, 0), (0, 0, 200),
             Blend(Lambertian(checker_texture()),
                   Lambertian(SolidColor(0, 1, 0)), blend_factor)),
        Sphere((0, 500, -200), 50.0, DiffuseLight(15.0, 15.0, 15.0)),
    ]
    camera = CameraConfig(vertical_fov_degrees=35.0,
                          look_from=(0.0, 400.0, -100.0))
    return Scene(Bvh(world), camera, (0.0, 0.0, 0.0), render_config)


def create_sponza_class_scene(render_config, n_cells=362, seed=7,
                              textured=True):
    """Sponza-class workload: a procedurally displaced terrain mesh of
    2*n_cells^2 triangles (default 262,088 — the scale of the reference
    README's sponza render) inside a lit room. Stresses the same things the
    sponza benchmark does — a deep BVH over a large triangle soup with an
    interior camera — without shipping a large binary asset.

    textured=True (the default, and what the benchmark measures) gives the
    terrain an image albedo + tangent-space normal map with tiled
    per-vertex UVs, like the reference's showcase sponza render
    (README.md:23-27, texture.rs:167-180): the at-scale fast path then
    exercises the texture arena, UV interpolation and shading-normal
    machinery, not just solid-color shading.
    """
    from solstrale.scene import TriangleMesh

    rng = np.random.default_rng(seed)
    xs = np.linspace(-10.0, 10.0, n_cells + 1)
    zs = np.linspace(-10.0, 10.0, n_cells + 1)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = (np.sin(X * 0.7) * np.cos(Z * 0.9)
         + 0.15 * rng.standard_normal(X.shape))
    P = np.stack([X, Y, Z], -1)
    a, b, c, d = P[:-1, :-1], P[1:, :-1], P[1:, 1:], P[:-1, 1:]
    verts = np.concatenate(
        [np.stack([a, b, c], axis=2).reshape(-1, 3, 3),
         np.stack([a, c, d], axis=2).reshape(-1, 3, 3)], 0)
    if textured:
        # tiled UVs: one texture repeat per 8x8 cells (abs-wrap sampling)
        U = X / 20.0 * (n_cells / 8.0)
        V = Z / 20.0 * (n_cells / 8.0)
        UV = np.stack([U, V], -1)
        ua, ub, uc, ud = UV[:-1, :-1], UV[1:, :-1], UV[1:, 1:], UV[:-1, 1:]
        uvs = np.concatenate(
            [np.stack([ua, ub, uc], axis=2).reshape(-1, 3, 2),
             np.stack([ua, uc, ud], axis=2).reshape(-1, 3, 2)], 0)
        mat = Lambertian(albedo_texture(), normal_texture())
        terrain = TriangleMesh(verts, mat, uvs=uvs)
    else:
        terrain = TriangleMesh(verts,
                               Lambertian(SolidColor(0.73, 0.73, 0.73)))
    world = [
        terrain,
        # room shell so secondary rays keep bouncing (interior workload)
        Quad((-12, -3, -12), (24, 0, 0), (0, 0, 24),
             Lambertian(SolidColor(0.5, 0.5, 0.5))),
        Quad((-12, -3, -12), (24, 0, 0), (0, 14, 0),
             Lambertian(SolidColor(0.6, 0.5, 0.4))),
        Quad((-12, -3, 12), (24, 0, 0), (0, 14, 0),
             Lambertian(SolidColor(0.4, 0.5, 0.6))),
        Quad((-4, 10.5, -4), (8, 0, 0), (0, 0, 8),
             DiffuseLight(15.0, 15.0, 15.0)),
    ]
    # camera INSIDE the room (the shell's far wall is at z=12): from
    # z=14 the view is the unlit back of that wall and the whole render
    # is black — caught in round 4; every prior sponza number measured
    # that degenerate 2-segment workload
    camera = CameraConfig(vertical_fov_degrees=40.0, aperture_size=0.0,
                          look_from=(0.0, 6.0, 9.0), look_at=(0.0, 0.0, 0.0))
    return Scene(Bvh(world), camera, (0.0, 0.0, 0.0), render_config)


def _terrain_grid(n_cells, seed):
    """Displaced-terrain vertex grid + tiled UV grid (shared by the
    sponza-class fixtures)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-10.0, 10.0, n_cells + 1)
    zs = np.linspace(-10.0, 10.0, n_cells + 1)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = (np.sin(X * 0.7) * np.cos(Z * 0.9)
         + 0.15 * rng.standard_normal(X.shape))
    P = np.stack([X, Y, Z], -1)
    U = X / 20.0 * (n_cells / 8.0)
    V = Z / 20.0 * (n_cells / 8.0)
    UV = np.stack([U, V], -1)
    return P, UV


def _region_mesh(P, UV, i0, i1, j0, j1, material):
    """TriangleMesh over the cell block [i0, i1) x [j0, j1)."""
    from solstrale.scene import TriangleMesh

    Pb = P[i0:i1 + 1, j0:j1 + 1]
    UVb = UV[i0:i1 + 1, j0:j1 + 1]
    a, b, c, d = Pb[:-1, :-1], Pb[1:, :-1], Pb[1:, 1:], Pb[:-1, 1:]
    verts = np.concatenate(
        [np.stack([a, b, c], axis=2).reshape(-1, 3, 3),
         np.stack([a, c, d], axis=2).reshape(-1, 3, 3)], 0)
    ua, ub, uc, ud = (UVb[:-1, :-1], UVb[1:, :-1], UVb[1:, 1:],
                      UVb[:-1, 1:])
    uvs = np.concatenate(
        [np.stack([ua, ub, uc], axis=2).reshape(-1, 3, 2),
         np.stack([ua, uc, ud], axis=2).reshape(-1, 3, 2)], 0)
    return TriangleMesh(verts, material, uvs=uvs)


def create_sponza_production_scene(render_config, n_cells=360, seed=7):
    """Production-diversity sponza-class workload: the displaced terrain
    (2*n_cells^2 = 259,200 triangles) split into a 4x4 grid of material
    regions covering every material kind — image-textured and solid
    lambertians (some normal-mapped), fuzzy and textured metals,
    dielectrics, stochastic blends — plus 4 textures and 4 emitters of all
    three light shapes. This is the shape of the reference's showcase
    renders (multi-material multi-texture OBJ scenes, README.md:23-27;
    MTL material maps loader/obj.rs:57-76), at BVH scale: it exercises
    texture-arena contention, blend/dielectric/metal dispatch and the
    O(#lights) NEE pdf loop (pdf.rs:88-102) in the same frame as the
    262k-prim traversal."""
    wall_c = albedo_texture()
    wall_n = normal_texture()
    tex_j = ground_texture()
    checker = checker_texture()
    earth = height_albedo_texture()

    mats = [
        Lambertian(wall_c, wall_n),
        Lambertian(tex_j),
        Lambertian(checker),
        Lambertian(SolidColor(0.8, 0.3, 0.25)),
        Metal(SolidColor(0.9, 0.8, 0.6), None, 0.1),
        Metal(checker, None, 0.3),
        Dielectric(SolidColor(1.0, 1.0, 1.0), None, 1.5),
        Blend(Lambertian(wall_c), Metal(SolidColor(0.8, 0.8, 0.9),
                                        None, 0.05), 0.5),
        Lambertian(earth),
        Metal(SolidColor(0.7, 0.7, 0.8), None, 0.05),
        Blend(Lambertian(checker), Dielectric(SolidColor(1.0, 1.0, 1.0),
                                              None, 1.3), 0.3),
        Lambertian(SolidColor(0.2, 0.5, 0.8), wall_n),
        Metal(wall_c, None, 0.2),
        Dielectric(SolidColor(0.9, 0.95, 1.0), None, 1.1),
        Blend(Metal(tex_j, None, 0.4),
              Lambertian(SolidColor(0.6, 0.6, 0.2)), 0.7),
        Lambertian(tex_j, wall_n),
    ]
    P, UV = _terrain_grid(n_cells, seed)
    step = n_cells // 4
    world = []
    for i in range(4):
        for j in range(4):
            world.append(_region_mesh(P, UV, i * step, (i + 1) * step,
                                      j * step, (j + 1) * step,
                                      mats[i * 4 + j]))
    world += [
        Quad((-12, -3, -12), (24, 0, 0), (0, 0, 24),
             Lambertian(SolidColor(0.5, 0.5, 0.5))),
        Quad((-12, -3, -12), (24, 0, 0), (0, 14, 0),
             Lambertian(SolidColor(0.6, 0.5, 0.4))),
        Quad((-12, -3, 12), (24, 0, 0), (0, 14, 0),
             Lambertian(SolidColor(0.4, 0.5, 0.6))),
        # 4 emitters, all three light shapes (scenes.rs:17-122 uses the
        # same trio on the kitchen-sink scene)
        Quad((-4, 10.5, -4), (8, 0, 0), (0, 0, 8),
             DiffuseLight(12.0, 12.0, 12.0)),
        Sphere((-8.0, 7.0, -8.0), 1.2, DiffuseLight(18.0, 14.0, 8.0)),
        Sphere((8.0, 7.0, 8.0), 1.2, DiffuseLight(8.0, 12.0, 18.0)),
        Triangle((-3, 9.0, 11.5), (3, 9.0, 11.5), (0, 11.5, 11.5),
                 DiffuseLight(14.0, 14.0, 14.0)),
    ]
    camera = CameraConfig(vertical_fov_degrees=40.0, aperture_size=0.0,
                          look_from=(0.0, 6.0, 9.0), look_at=(0.0, 0.0, 0.0))
    return Scene(Bvh(world), camera, (0.0, 0.0, 0.0), render_config)


def create_many_light_scene(render_config, n_lights=64, n_cells=96, seed=3):
    """Many-light fixture: a displaced-terrain BVH scene lit by an
    ``n_lights`` grid of sphere emitters (plus one quad emitter). Exercises
    the vectorized (R, L) light-pdf fallback above _MEAN3_UNROLL_MAX —
    the reference pays O(#lights) re-intersections per shading event
    (pdf.rs:88-102), the cost center a real many-emitter sponza hits
    first."""
    from solstrale.scene import TriangleMesh

    P, UV = _terrain_grid(n_cells, seed)
    a, b, c, d = P[:-1, :-1], P[1:, :-1], P[1:, 1:], P[:-1, 1:]
    verts = np.concatenate(
        [np.stack([a, b, c], axis=2).reshape(-1, 3, 3),
         np.stack([a, c, d], axis=2).reshape(-1, 3, 3)], 0)
    world = [TriangleMesh(verts, Lambertian(SolidColor(0.7, 0.7, 0.7))),
             Quad((-4, 10.5, -4), (8, 0, 0), (0, 0, 8),
                  DiffuseLight(6.0, 6.0, 6.0))]
    side = int(np.ceil(np.sqrt(n_lights - 1)))
    rng = np.random.default_rng(seed)
    k = 0
    for i in range(side):
        for j in range(side):
            if k >= n_lights - 1:
                break
            x = -9.0 + 18.0 * i / max(side - 1, 1)
            z = -9.0 + 18.0 * j / max(side - 1, 1)
            col = 4.0 + 8.0 * rng.random(3)
            world.append(Sphere((x, 6.0 + 2.0 * rng.random(), z), 0.3,
                                DiffuseLight(*col)))
            k += 1
    camera = CameraConfig(vertical_fov_degrees=40.0, aperture_size=0.0,
                          look_from=(0.0, 6.0, 9.0), look_at=(0.0, 0.0, 0.0))
    return Scene(Bvh(world), camera, (0.0, 0.0, 0.0), render_config)


def create_mini_kitchen_sink(render_config):
    """Solid-color analogue of the kitchen-sink scene without a BVH-sized
    primitive count: every material kind (lambertian, metal, dielectric,
    light, blend) plus a constant medium and a thin-lens camera."""
    camera = CameraConfig(vertical_fov_degrees=20.0, aperture_size=0.1,
                          look_from=(-5.0, 3.0, 6.0),
                          look_at=(0.25, 1.0, 0.0))
    red = Lambertian(SolidColor(1, 0, 0))
    world = [
        Quad((-5, 0, -15), (20, 0, 0), (0, 0, 20),
             Blend(Lambertian(SolidColor(0.3, 0.6, 0.3)),
                   Metal(SolidColor(0.8, 0.8, 0.9), None, 0.2), 0.4)),
        Sphere((-1, 1, 0), 1.0, Dielectric(SolidColor(1, 1, 1), None, 1.5)),
        ConstantMedium(
            Bvh(new_box((0, 0, 0.5), (1, 2, 1.5), red)), 0.1, (1, 1, 1)),
        Sphere((10, 5, 10), 10.0, DiffuseLight(10, 10, 10)),
        Quad((-1, 10, -1), (2, 0, 0), (0, 0, 2),
             DiffuseLight(12, 12, 12, attenuation_half_length=10.0)),
    ]
    world += new_box((0, 0, -0.5), (1, 2, 0.5), red)
    return Scene(Bvh(world), camera, (0.2, 0.3, 0.5), render_config)
