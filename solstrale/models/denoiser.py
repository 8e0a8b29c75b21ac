"""Denoising models replacing the reference's OIDN C++ binary
(``/root/reference/src/post/oidn.rs``) with device-resident, differentiable
equivalents that share OIDN's interface: (color, albedo, normal) → color.

Two backends:
- ``denoise_bilateral``: a deterministic cross-bilateral filter guided by the
  albedo/normal aux channels (mirrors OIDN's ``clean_aux`` usage,
  oidn.rs:33-41). No weights needed; differentiable.
- ``DenoiserCNN``: a small flax U-Net trained on own renders (train script in
  ``models/train_denoiser.py``); used when trained weights are available.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _shift(x, dy, dx):
    return jnp.roll(x, (dy, dx), axis=(0, 1))


@jax.jit
def denoise_bilateral(color, albedo, normal, radius=3,
                      sigma_spatial=2.0, sigma_color=0.2,
                      sigma_albedo=0.1, sigma_normal=0.3):
    """Cross-bilateral denoiser: weights combine spatial, color, albedo and
    normal similarity. All inputs (H, W, 3) in [0, 1]-ish tone-mapped space.
    """
    acc = jnp.zeros_like(color)
    wacc = jnp.zeros(color.shape[:2] + (1,), color.dtype)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            c = _shift(color, dy, dx)
            a = _shift(albedo, dy, dx)
            n = _shift(normal, dy, dx)
            w_sp = jnp.exp(-(dy * dy + dx * dx) / (2 * sigma_spatial ** 2))
            dc = jnp.sum((c - color) ** 2, -1, keepdims=True)
            da = jnp.sum((a - albedo) ** 2, -1, keepdims=True)
            dn = jnp.sum((n - normal) ** 2, -1, keepdims=True)
            w = w_sp * jnp.exp(-dc / (2 * sigma_color ** 2)
                               - da / (2 * sigma_albedo ** 2)
                               - dn / (2 * sigma_normal ** 2))
            acc = acc + c * w
            wacc = wacc + w
    return acc / jnp.maximum(wacc, 1e-8)


try:
    import flax.linen as nn

    class DenoiserCNN(nn.Module):
        """Small U-Net-style denoiser; inputs concat(color, albedo, normal)."""

        features: int = 32

        @nn.compact
        def __call__(self, color, albedo, normal):
            x = jnp.concatenate([color, albedo, normal], axis=-1)[None]
            f = self.features
            h1 = nn.relu(nn.Conv(f, (3, 3))(x))
            h1 = nn.relu(nn.Conv(f, (3, 3))(h1))
            h2 = nn.avg_pool(h1, (2, 2), (2, 2))
            h2 = nn.relu(nn.Conv(2 * f, (3, 3))(h2))
            h2 = nn.relu(nn.Conv(2 * f, (3, 3))(h2))
            h3 = jax.image.resize(h2, h1.shape[:3] + (2 * f,), "bilinear")
            h = jnp.concatenate([h1, h3], axis=-1)
            h = nn.relu(nn.Conv(f, (3, 3))(h))
            out = nn.Conv(3, (3, 3))(h)
            return jnp.clip(x[..., :3] + out, 0.0, 1.0)[0]

except Exception:  # pragma: no cover - flax always present in target env
    DenoiserCNN = None
