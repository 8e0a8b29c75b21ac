"""Bloom post processor (reference: ``/root/reference/src/post/bloom.rs``).

Data-parallel formulation: the bright-pass is elementwise, the blur is a
separable horizontal+vertical 1-D convolution — expressed as jnp convolutions
XLA fuses and vectorizes (the reference hand-rolls the same thing with rayon
par_iter loops, bloom.rs:92-143). Edge handling clamps to the border pixel
(bloom.rs:157-162) == 'edge' padding.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import create_gaussian_blur_weights
from . import PostProcessor


class BloomPostProcessor(PostProcessor):
    def __init__(self, kernel_size_fraction, threshold=None, max_intensity=None):
        if not (0.0 <= kernel_size_fraction <= 0.5):
            raise ValueError("kernel_size_fraction must be between 0 and 0.5")
        self.kernel_size_fraction = float(kernel_size_fraction)
        # default threshold = |(1,1,1)| (bloom.rs:38)
        self.threshold = float(np.sqrt(3.0)) if threshold is None else float(threshold)
        self.max_intensity = (float("inf") if max_intensity is None
                              else float(max_intensity))

    def intermediate_post_process(self, pixel_sums, albedo_sums, normal_sums,
                                  width, height, num_samples):
        # thresholds scale by num_samples: buffers are unnormalized sums
        # (bloom.rs:85-86)
        threshold = self.threshold * num_samples
        max_intensity = self.max_intensity * num_samples
        kernel_size = int(self.kernel_size_fraction * width) * 2 + 1

        weights = jnp.asarray(
            create_gaussian_blur_weights(kernel_size, kernel_size / 5.0),
            jnp.float32)

        img = jnp.asarray(pixel_sums, jnp.float32)
        return _bloom(img, weights, jnp.float32(threshold),
                      jnp.float32(max_intensity))


@jax.jit
def _bloom(img, weights, threshold, max_intensity):
    # bright pass with intensity cap (bloom.rs:92-105)
    norm = jnp.linalg.norm(img, axis=-1, keepdims=True)
    capped = jnp.where(norm > max_intensity,
                       img / jnp.maximum(norm, 1e-30) * max_intensity, img)
    bright = jnp.where(norm >= threshold, capped, 0.0)

    k = weights.shape[0]
    half = k // 2

    def blur_axis(x, axis):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (half, half)
        xp = jnp.pad(x, pad, mode="edge")
        out = jnp.zeros_like(x)
        for i in range(k):
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(i, i + x.shape[axis])
            out = out + xp[tuple(sl)] * weights[i]
        return out

    blurred = blur_axis(blur_axis(bright, 1), 0)  # horizontal then vertical
    return img + blurred
