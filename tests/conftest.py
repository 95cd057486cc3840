import os

# The CI image ships libtpu but no TPU: left alone, jax's backend discovery
# stalls for minutes trying to initialize it.  Default to CPU (tier-1 runs
# in interpret mode anyway); export JAX_PLATFORMS explicitly to override,
# e.g. on a real TPU host.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# The suite is XLA-compile-bound (hundreds of model-sized jits on a slow
# CPU), and every tensor in it is tiny: skip most backend optimization
# passes.  Compiles get ~2x faster; steady-state execution is slightly
# slower, which is irrelevant at test sizes.  Correctness assertions are
# tolerance- or bit-exactness-based and do not depend on XLA fusion choices.
os.environ.setdefault("JAX_DISABLE_MOST_OPTIMIZATIONS", "1")

# NOTE: the persistent XLA compilation cache (JAX_COMPILATION_CACHE_DIR) is
# deliberately NOT enabled process-wide: on this jax/CPU build it corrupts
# the CPU client once the train/serve loop is involved (aborts/segfaults in
# later checkpoint saves even when the cache is config.update()-disabled for
# the affected module — reproduced via test_fault_tolerance).  Only the
# isolated subprocess tests (test_pipeline, test_multidevice) opt in.

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the hand-written kernels have no CPU "
        "mode); skipped with a reason where torch.cuda.is_available() is False")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def disable_compilation_cache():
    """Module-scoped generator: cache off on entry, restored on exit.

    Usage (in modules that drive the train/serve loops):

        _no_xla_cache = pytest.fixture(autouse=True, scope="module")(
            conftest.disable_compilation_cache)
    """
    import jax
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def restore_design_registry():
    """Module-scoped generator: snapshot the gemm_sims design registry on
    entry, restore it on exit.

    Modules that call ``kernels.backends.register_kernel_backends`` (or
    register ad-hoc designs) use this so the ``tugemm_pallas`` /
    ``tubgemm_pallas`` mirrors don't leak into later modules — several
    consumers iterate the *live* ``gemm_sims.DESIGNS`` and expect exactly
    the four calibrated designs.  Usage:

        _registry = pytest.fixture(autouse=True, scope="module")(
            conftest.restore_design_registry)
    """
    from repro.core import gemm_sims
    saved = gemm_sims.registry_snapshot()
    yield
    gemm_sims.registry_restore(saved)
