"""Texture tests: bump-map auto-detection on generated normal and height
maps written to image files (texture.rs:182-203) and arena sampling
semantics (texture.rs:167-180)."""
import jax.numpy as jnp
import numpy as np

from scenes import height_image, normal_texture
from solstrale.scene.textures import ImageMap, SolidColor, load_bump_map


def _write(path, image_u8):
    from PIL import Image

    Image.fromarray(image_u8).save(path)
    return str(path)


def test_detect_normal_map(tmp_path):
    path = _write(tmp_path / "wall_n.png", normal_texture().image)
    kind, img = load_bump_map(path)
    assert kind == "normal"
    assert img.shape == normal_texture().image.shape


def test_detect_height_map(tmp_path):
    kind, img = load_bump_map(_write(tmp_path / "height.jpg", height_image()))
    assert kind == "height"


def test_image_map_errors():
    import pytest

    with pytest.raises(FileNotFoundError, match="Failed to open image texture"):
        ImageMap.load("/does/not/exist.jpg")


def test_arena_sampling_wrap():
    """Nearest-neighbor sample with abs-wrap UVs and flipped v."""
    from solstrale import (Bvh, CameraConfig, DiffuseLight, Lambertian,
                           RenderConfig, Scene, Sphere)
    from solstrale.renderer.integrator import sample_texture
    from solstrale.scene.compile import compile_scene

    img = np.zeros((2, 2, 3), np.uint8)
    img[0, 0] = [255, 0, 0]    # top-left
    img[0, 1] = [0, 255, 0]    # top-right
    img[1, 0] = [0, 0, 255]    # bottom-left
    img[1, 1] = [255, 255, 0]  # bottom-right
    tex = ImageMap(img)

    scene = Scene(
        Bvh([Sphere((0, 5, 0), 1.0, DiffuseLight(1, 1, 1)),
             Sphere((0, 0, 0), 1.0, Lambertian(tex))]),
        CameraConfig(look_from=(0, 0, 4)), (0, 0, 0),
        RenderConfig(width=4, height=4))
    cs = compile_scene(scene)
    tid = int(cs.materials.albedo_tex[1])

    def sample(u, v):
        uv = (jnp.asarray([u], jnp.float32), jnp.asarray([v], jnp.float32))
        rgb = sample_texture(cs.textures, jnp.asarray([tid]), uv)
        return np.asarray([float(c[0]) for c in rgb])

    # v flipped: uv (0,0) → image bottom row; x=u*(w-1) truncated
    np.testing.assert_allclose(sample(0.0, 0.0), [0, 0, 1])      # bottom-left
    np.testing.assert_allclose(sample(0.99, 0.0), [0, 0, 1])     # x trunc = 0
    # v≈1 → flipped to the image top row
    np.testing.assert_allclose(sample(0.0, 0.99), [1, 0, 0])
    # u=1.0 wraps to 0 (abs % 1)
    np.testing.assert_allclose(sample(1.0, 0.0), [0, 0, 1])
    # negative u: |−0.5| % 1 = 0.5 → x = 0 (0.5*1 trunc)
    np.testing.assert_allclose(sample(-0.5, 0.0), [0, 0, 1])


def test_solid_color_from_vec3():
    s = SolidColor.new_from_vec3([0.1, 0.2, 0.3])
    np.testing.assert_allclose(s.rgb, [0.1, 0.2, 0.3])
