"""Renderer orchestration: progressive sample loop, progress/abort protocol,
post-processing chain. Mirrors ``/root/reference/src/renderer/mod.rs`` with a
host-side Python loop around one jitted whole-image sample pass; accumulation
buffers live on device (the data-parallel analogue of the reference's
Arc<Mutex<Vec<Vec3>>> row merging, renderer/mod.rs:223-291 — no locks, the
wavefront owns the whole frame).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np


@dataclass
class RenderImageStrategy:
    """When progress reports carry an image (renderer/mod.rs:86-118)."""

    def should_generate_image(self, sample, total_samples, now, last_time):
        raise NotImplementedError


class EverySample(RenderImageStrategy):
    def should_generate_image(self, sample, total_samples, now, last_time):
        return True


@dataclass
class Interval(RenderImageStrategy):
    seconds: float = 1.0

    def should_generate_image(self, sample, total_samples, now, last_time):
        return sample == total_samples or (now - last_time) > self.seconds


class OnlyFinal(RenderImageStrategy):
    def should_generate_image(self, sample, total_samples, now, last_time):
        return sample == total_samples


@dataclass
class RenderProgress:
    """Progress report (renderer/mod.rs:75-84)."""

    progress: float
    fps: float | None = None
    estimated_time_left: float = 0.0
    render_image: np.ndarray | None = None
    # path segments traced so far (a device scalar; float() it to read)
    segments: object = 0.0


class RenderConfig:
    """Render parameters; defaults match renderer/mod.rs:41-52 plus a `seed`
    the reference cannot offer (its RNG is unseedable, random.rs:4-21)."""

    def __init__(self, width=300, height=200, samples_per_pixel=50,
                 shader=None, post_processors=None,
                 render_image_strategy=None, seed=0, samples_per_batch=1):
        from .shader import PathTracingShader

        self.width = int(width)
        self.height = int(height)
        self.samples_per_pixel = int(samples_per_pixel)
        self.shader = shader if shader is not None else PathTracingShader(50)
        self.post_processors = list(post_processors or [])
        self.render_image_strategy = render_image_strategy or OnlyFinal()
        self.seed = int(seed)
        # samples fused into one device program per progress step; raise to
        # amortize dispatch overhead when per-sample progress isn't needed
        self.samples_per_batch = int(samples_per_batch)

    def needs_albedo_and_normal_colors(self):
        return any(p.needs_albedo_and_normal_colors()
                   for p in self.post_processors)


class Renderer:
    """Executes the progressive render loop (renderer/mod.rs:138-358)."""

    def __init__(self, scene):
        from ..post import NopPostProcessor
        from ..scene.compile import compile_scene

        self.scene = scene
        self.config = scene.render_config
        # raises "Scene should have at least one light" (renderer/mod.rs:143)
        self.compiled = compile_scene(scene)
        self.post_processors = list(self.config.post_processors)
        if not self.post_processors:
            self.post_processors.append(NopPostProcessor())

    def render(self, abort=None, resume_from=None, checkpoint_path=None,
               checkpoint_every=0, profile_dir=None):
        """Generator yielding RenderProgress per sample batch.

        - `abort`: zero-arg callable checked between batches (the
          cooperative abort channel of renderer/mod.rs:237-239);
        - `resume_from`: path of a checkpoint to continue from;
        - `checkpoint_path` + `checkpoint_every`: persist the accumulation
          state every N samples (preemption tolerance);
        - `profile_dir`: capture a JAX profiler (xprof) trace of the loop.
        """
        from . import integrator
        from .checkpoint import load_checkpoint, save_checkpoint

        cfg = self.config
        w, h = cfg.width, cfg.height
        spp = cfg.samples_per_pixel
        need_aux = cfg.needs_albedo_and_normal_colors()
        strategy = cfg.render_image_strategy

        pixel_sums = jnp.zeros((h, w, 3), jnp.float32)
        albedo_sums = jnp.zeros((h, w, 3), jnp.float32)
        normal_sums = jnp.zeros((h, w, 3), jnp.float32)
        sample = 0
        segments = jnp.float32(0.0)
        if resume_from is not None:
            ck = load_checkpoint(resume_from)
            pixel_sums = jnp.asarray(ck["pixel_sums"])
            albedo_sums = jnp.asarray(ck["albedo_sums"])
            normal_sums = jnp.asarray(ck["normal_sums"])
            sample = ck["samples_done"]

        start = time.monotonic()
        last_image_time = -1e30
        profiler = None
        if profile_dir is not None:
            import jax

            profiler = jax.profiler.trace(profile_dir)
            profiler.__enter__()

        while sample < spp:
            batch = min(cfg.samples_per_batch, spp - sample)
            if abort is not None and abort():
                return
            color, albedo, normal, segs = integrator.render_sample_batch(
                self.compiled, jnp.int32(sample + 1), jnp.int32(cfg.seed),
                width=w, height=h, max_depth=cfg.shader.max_depth,
                shader_kind=cfg.shader.kind, need_aux=need_aux,
                n_samples=batch)
            sample += batch
            segments = segments + segs
            pixel_sums = pixel_sums + color
            if need_aux:
                albedo_sums = albedo_sums + albedo
                normal_sums = normal_sums + normal

            if checkpoint_path and checkpoint_every and \
                    (sample % checkpoint_every == 0 or sample == spp):
                from .checkpoint import save_checkpoint

                save_checkpoint(checkpoint_path, pixel_sums, albedo_sums,
                                normal_sums, sample, cfg.seed)

            now = time.monotonic()
            render_image = None
            if strategy.should_generate_image(sample, spp, now, last_image_time):
                last_image_time = now
                if abort is not None and abort():
                    return
                inter = pixel_sums
                for p in self.post_processors[:-1]:
                    inter = p.intermediate_post_process(
                        inter, albedo_sums, normal_sums, w, h, sample)
                render_image = self.post_processors[-1].post_process(
                    inter, albedo_sums, normal_sums, w, h, sample)

            elapsed = max(now - start, 1e-3)
            yield RenderProgress(
                progress=sample / spp,
                fps=sample / elapsed,
                estimated_time_left=elapsed / sample * (spp - sample),
                render_image=render_image,
                segments=segments,
            )

        if profiler is not None:
            profiler.__exit__(None, None, None)

    def render_final(self, abort=None):
        """Run to completion, return the final u8 image (H, W, 3)."""
        image = None
        for progress in self.render(abort):
            if progress.render_image is not None:
                image = progress.render_image
        return image


def ray_trace(scene, abort=None):
    """Library entry point (lib.rs:93-99): yields RenderProgress."""
    yield from Renderer(scene).render(abort)
