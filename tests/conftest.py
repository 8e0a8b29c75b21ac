"""Test harness configuration. Tests run on the CPU with 8 virtual devices
(sharding tests need a mesh) unless JAX_PLATFORMS names another platform:
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` runs the card-only
tests on a GPU; everywhere else they skip (see the ``gpu`` fixture)."""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_ROOT = "/root/reference"


def reference_path(*parts):
    return os.path.join(REFERENCE_ROOT, *parts)


@pytest.fixture
def gpu():
    """Card-only tests take this fixture: it skips unless JAX's default
    backend is a GPU (decided when the test runs, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU: the traversal kernel has no CPU "
                    "lowering outside interpret mode")


@pytest.fixture
def kernel_interpret(monkeypatch):
    """Route BVH scenes through the traversal kernel in interpret mode on
    the CPU (the production choice there is the XLA walk), so renders and
    gradients exercise the kernel's results end to end."""
    import functools

    from solstrale.ops import traverse

    monkeypatch.setattr(
        traverse, "hit_path",
        lambda cs: "kernel" if cs.kbvh is not None else "xla")
    monkeypatch.setattr(
        traverse, "bvh_closest_hit_kernel",
        functools.partial(traverse.bvh_closest_hit_kernel, interpret=True))
    jax.clear_caches()
    yield
    jax.clear_caches()
