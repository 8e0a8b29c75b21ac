"""Checkpoint / resume of the progressive render state.

The reference's closest structure is its unnormalized accumulation buffer
(renderer/mod.rs:223-224) — resuming is implicit in the sum + sample
counter. Here it is explicit and durable: the accumulation planes, the
sample cursor, and the seed round-trip through a single .npz file, so a
preempted multi-hour render (or a preempted worker of a sharded render) resumes
exactly — the counter-based RNG guarantees the continuation renders the
identical remaining samples.
"""
from __future__ import annotations

import numpy as np


def save_checkpoint(path, pixel_sums, albedo_sums, normal_sums,
                    samples_done, seed):
    np.savez_compressed(
        path,
        pixel_sums=np.asarray(pixel_sums),
        albedo_sums=np.asarray(albedo_sums),
        normal_sums=np.asarray(normal_sums),
        samples_done=np.int64(samples_done),
        seed=np.int64(seed),
    )


def load_checkpoint(path):
    z = np.load(path)
    return dict(
        pixel_sums=z["pixel_sums"],
        albedo_sums=z["albedo_sums"],
        normal_sums=z["normal_sums"],
        samples_done=int(z["samples_done"]),
        seed=int(z["seed"]),
    )
