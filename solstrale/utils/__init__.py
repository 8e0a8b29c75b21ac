"""Image/color utilities: tone mapping, gaussian kernels, height→normal maps.

Mirrors ``/root/reference/src/util/`` semantics with vectorized jnp/numpy.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np


def use_compile_cache(default_dir):
    """Keep JAX's persistent compilation cache in JAX_COMPILATION_CACHE_DIR
    when that is set (JAX reads the variable itself), else in
    ``default_dir``. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", default_dir)
    return default_dir

COLOR_INTENSITY_MIN = -0.999
COLOR_INTENSITY_MAX = 0.999


def to_float(col, samples_per_pixel):
    """Normalize an accumulated color sum by sample count, gamma-2 correct
    (sqrt) and clamp to ±0.999 (rgb_color.rs:21-34). Works on (..., 3)."""
    scale = 1.0 / samples_per_pixel
    c = jnp.sqrt(jnp.maximum(col * scale, 0.0))
    return jnp.clip(c, COLOR_INTENSITY_MIN, COLOR_INTENSITY_MAX)


def to_rgb_u8(col, samples_per_pixel):
    """Accumulated color sum → u8 image; ×256 then truncate like the
    reference's `as u8` cast (rgb_color.rs:14-17)."""
    c = to_float(col, samples_per_pixel)
    return jnp.clip(jnp.floor(256.0 * c), 0, 255).astype(jnp.uint8)


def rgb_to_vec3(pixel_u8):
    """u8 rgb → float color in [0,1] (rgb_color.rs:37-43)."""
    return np.asarray(pixel_u8, np.float64) / 255.0


def create_gaussian_blur_weights(kernel_size, std_dev):
    """Normalized 1-D Gaussian kernel (gaussian.rs:11-25)."""
    mean = (kernel_size - 1) / 2.0
    xs = np.arange(kernel_size, dtype=np.float64)
    a = (xs - mean) / std_dev
    w = np.exp(-0.5 * a * a)
    return w / w.sum()


HEIGHT_MAP_STRENGTH = 6.0


def height_to_normal_map(height_u8):
    """Sobel-like height→normal conversion (height_map.rs:49-95).

    height_u8: (H, W, 3) u8 image; uses the red channel scaled to [0,1].
    Returns a (H, W, 3) u8 normal map (x,y,z scaled to 0..1 → 0..255).
    """
    img = np.asarray(height_u8, np.float32)[..., 0] / 255.0
    # duplicate edge pixels (height_map.rs:20-45)
    p = np.pad(img, 1, mode="edge")
    nw, n_, ne = p[:-2, :-2], p[:-2, 1:-1], p[:-2, 2:]
    w_, e_ = p[1:-1, :-2], p[1:-1, 2:]
    sw, s_, se = p[2:, :-2], p[2:, 1:-1], p[2:, 2:]
    x_norm = -(se - sw + 2.0 * (e_ - w_) + ne - nw)
    y_norm = -(nw - sw + 2.0 * (n_ - s_) + ne - se)
    z_norm = np.full_like(x_norm, 1.0 / HEIGHT_MAP_STRENGTH)
    v = np.stack([x_norm, y_norm, z_norm], axis=-1)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    v01 = v * 0.5 + 0.5
    return (v01 * 255.0).astype(np.uint8)


def compare_images_rms(a_u8, b_u8, resize_to=(100, 50)):
    """Blur-downsample-then-compare similarity score, replicating the
    reference test harness (integration_tests.rs:326-350): both images are
    Gaussian-resized to 100x50 and scored with an RMS-based similarity in
    [0, 1] (1 = identical). Used as the golden-image gate at > 0.95."""
    import cv2

    w, h = resize_to
    a = np.asarray(a_u8, np.uint8)
    b = np.asarray(b_u8, np.uint8)
    a_small = cv2.resize(cv2.GaussianBlur(a, (5, 5), 1.0), (w, h),
                         interpolation=cv2.INTER_AREA).astype(np.float64) / 255.0
    b_small = cv2.resize(cv2.GaussianBlur(b, (5, 5), 1.0), (w, h),
                         interpolation=cv2.INTER_AREA).astype(np.float64) / 255.0
    rmse = np.sqrt(np.mean((a_small - b_small) ** 2))
    return 1.0 - rmse
