"""Two-phase drain-tail compaction (trace_queued): the wide phase hands
surviving in-flight rays to a pool 1/8 the width once the queue is fully
claimed. Estimator-identical: same paths, same RNG draws, exact same
segment count; image differs only by scatter-collision fp reassociation."""
import numpy as np

import jax.numpy as jnp

from scenes import create_simple_test_scene
from solstrale import RenderConfig
from solstrale.renderer import integrator
from solstrale.scene.compile import compile_scene

W, H, SPP = 64, 64, 8  # 32768 queue entries -> tail path active at 32768


def test_two_phase_tail_matches_single_phase():
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP, seed=1)
    cs = compile_scene(create_simple_test_scene(cfg))

    # lanes=32768 activates the two-phase tail (tail pool 4096)
    acc2, segs2 = integrator.trace_queued(
        cs, None, jnp.int32(1), SPP, jnp.int32(1), width=W, height=H,
        max_depth=12, lanes=32768)
    # lanes=8192 stays single-phase (below the 32768 activation floor)
    acc1, segs1 = integrator.trace_queued(
        cs, None, jnp.int32(1), SPP, jnp.int32(1), width=W, height=H,
        max_depth=12, lanes=8192)

    # segment counts are ulp-fragile ACROSS POOL SIZES even single-phase:
    # the XLA sweep's matmul tiling differs with R, and a tangent ray's
    # hit decision can flip (measured +2 of 54k on this scene at >=20480
    # lanes BEFORE two-phase existed). Within one pool size the two-phase
    # split itself adds no variance; allow the cross-R tolerance here.
    np.testing.assert_allclose(float(segs1), float(segs2), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(acc2), np.asarray(acc1),
                               rtol=1e-4, atol=1e-4)
    assert float(jnp.sum(acc2)) > 0
