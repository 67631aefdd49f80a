"""Test harness: run on an 8-device CPU platform unless told otherwise.

The suite runs on the CPU (`JAX_PLATFORMS=cpu`) with 8 virtual devices for
the sharding tests.  Tests marked `gpu` need an NVIDIA GPU; they skip
elsewhere and run on a card with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu

Some installed pytest plugin may import jax before this conftest runs, so
the platform is also set through jax.config (backends are not initialized
until first use, so this still takes effect).
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU "
                    "(JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu)")


@pytest.fixture
def kernel_route(monkeypatch):
    """Send every merge of the stack through the Pallas merge kernel
    (interpret mode) for the duration of a test; jit caches are cleared
    around it, since the route is chosen while a program is traced."""
    import cbl_tpu.wordset as wordset
    from cbl_tpu.ops import merge, merge_triton

    calls = []
    kernel = merge_triton.merge_sorted_cols

    def interp(a, b):
        calls.append(len(a))
        return kernel(a, b, interpret=True)

    for mod in (merge, wordset):
        monkeypatch.setattr(mod, "use_merge_kernel", lambda n: True)
    monkeypatch.setattr(merge_triton, "merge_sorted_cols", interp)
    jax.clear_caches()
    yield
    jax.clear_caches()
    assert calls, "no merge took the kernel route"
