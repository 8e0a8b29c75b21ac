"""Utility tests with the reference's exact expected values
(gaussian.rs:27-49, rgb_color.rs:45-62, height_map.rs)."""
import numpy as np

from solstrale.utils import (create_gaussian_blur_weights,
                             height_to_normal_map, rgb_to_vec3, to_rgb_u8)


def test_gaussian_weights_exact():
    w = create_gaussian_blur_weights(5, 1.0)
    np.testing.assert_allclose(w, [
        0.05448868454964294, 0.24420134200323332, 0.4026199468942474,
        0.24420134200323332, 0.05448868454964294])
    assert abs(w.sum() - 1.0) < 1e-8


def test_to_rgb_exact():
    # rgb_color.rs:58-61
    np.testing.assert_array_equal(
        np.asarray(to_rgb_u8(np.array([0.0, 0.3, 1.0]), 1)), [0, 140, 255])
    np.testing.assert_array_equal(
        np.asarray(to_rgb_u8(np.array([0.0, 0.3, 1.0]), 2)), [0, 99, 181])


def test_rgb_to_vec3():
    np.testing.assert_allclose(rgb_to_vec3([0, 100, 255]),
                               [0.0, 0.39215686274509803, 1.0])


def test_height_to_normal_map():
    # flat height → straight-up normal (0.5, 0.5, 1.0)
    flat = np.full((8, 8, 3), 128, np.uint8)
    n = height_to_normal_map(flat)
    np.testing.assert_array_equal(n[..., 0], 127)
    np.testing.assert_array_equal(n[..., 1], 127)
    assert (n[..., 2] > 250).all()

    # x-gradient → normal tilted in -x
    ramp = np.tile(np.linspace(0, 255, 8, dtype=np.uint8)[None, :, None],
                   (8, 1, 3))
    n = height_to_normal_map(ramp)
    center = n[4, 4]
    assert center[0] < 100  # tilted towards -x
    assert abs(int(center[1]) - 127) <= 2
