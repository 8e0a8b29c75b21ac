"""Scene compiler tests: flattening, light collection, error paths, texture
arena, camera precompute."""
import numpy as np
import pytest

from solstrale import (Blend, Bvh, CameraConfig, ConstantMedium,
                       DiffuseLight, Lambertian, Quad, RenderConfig,
                       Scene, SolidColor, Sphere, Triangle, new_box)
from solstrale.scene.compile import SceneError, compile_scene


def _scene(world):
    return Scene(world, CameraConfig(look_from=(0, 0, 4)), (0, 0, 0),
                 RenderConfig(width=20, height=10))


def test_no_light_error():
    # renderer/mod.rs:143-147 error text
    world = Bvh([Sphere((0, 0, 0), 1.0, Lambertian(SolidColor(1, 1, 0)))])
    with pytest.raises(SceneError, match="Scene should have at least one light"):
        compile_scene(_scene(world))


def test_light_collection():
    light = DiffuseLight(10, 10, 10)
    world = Bvh([
        Sphere((0, 5, 0), 1.0, light),
        Quad((0, 0, 0), (1, 0, 0), (0, 1, 0), light),
        Triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), light),
        Sphere((0, 0, 0), 1.0, Lambertian(SolidColor(1, 1, 0))),
        # media never contribute lights (constant_medium.rs:85-87)
        ConstantMedium(Bvh(new_box((0, 0, 0), (1, 1, 1), light)), 0.1, (1, 1, 1)),
    ])
    cs = compile_scene(_scene(world))
    assert cs.lights.kind.shape[0] == 3
    assert sorted(np.asarray(cs.lights.kind).tolist()) == [0, 1, 2]


def test_counts_and_media():
    red = Lambertian(SolidColor(1, 0, 0))
    world = Bvh([
        Sphere((0, 5, 0), 1.0, DiffuseLight(10, 10, 10)),
        *new_box((0, 0, 0), (1, 1, 1), red),
        ConstantMedium(Bvh(new_box((2, 0, 0), (3, 1, 1), red)), 0.2, (1, 1, 1)),
    ])
    cs = compile_scene(_scene(world))
    assert int(cs.solids.sph_valid.sum()) == 1
    assert int(cs.solids.qd_valid.sum()) == 6
    assert len(cs.media) == 1
    assert int(cs.media[0].boundary.qd_valid.sum()) == 6
    assert float(cs.media[0].neg_inv_density) == pytest.approx(-5.0)


def test_texture_arena_dedupe():
    tex = SolidColor(0.25, 0.5, 0.75)
    world = Bvh([
        Sphere((0, 5, 0), 1.0, DiffuseLight(10, 10, 10)),
        Sphere((0, 0, 0), 1.0, Lambertian(tex)),
        Sphere((2, 0, 0), 1.0, Lambertian(tex)),
    ])
    cs = compile_scene(_scene(world))
    # shared texture compiled once; arena holds light color + shared color
    assert cs.textures.offset.shape[0] == 2
    px = np.asarray(cs.textures.pixels)
    assert any(np.allclose(px[i], [0.25, 0.5, 0.75]) for i in range(len(px)))


def test_blend_flattening():
    b = Blend(Lambertian(SolidColor(1, 0, 0)),
              Lambertian(SolidColor(0, 1, 0)), 0.3)
    world = Bvh([
        Sphere((0, 5, 0), 1.0, DiffuseLight(10, 10, 10)),
        Sphere((0, 0, 0), 1.0, b),
    ])
    cs = compile_scene(_scene(world))
    kinds = np.asarray(cs.materials.kind)
    from solstrale.scene.materials import BLEND, LAMBERTIAN
    blend_rows = np.where(kinds == BLEND)[0]
    assert len(blend_rows) == 1
    row = blend_rows[0]
    m1 = int(cs.materials.blend_m1[row])
    m2 = int(cs.materials.blend_m2[row])
    assert kinds[m1] == LAMBERTIAN and kinds[m2] == LAMBERTIAN
    assert float(cs.materials.blend_factor[row]) == pytest.approx(0.3)


def test_camera_precompute():
    from solstrale.scene.compile import compile_camera

    cam = compile_camera(
        CameraConfig(vertical_fov_degrees=90.0, look_from=(0, 0, 1),
                     look_at=(0, 0, 0)), 200, 100)
    np.testing.assert_allclose(np.asarray(cam.origin), [0, 0, 1])
    # fov 90 → viewport height 2·tan(45°)=2, width 4 (aspect 2), focus 1
    np.testing.assert_allclose(np.asarray(cam.horizontal), [4, 0, 0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(cam.vertical), [0, 2, 0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(cam.lower_left), [-2, -1, 0],
                               atol=1e-5)
