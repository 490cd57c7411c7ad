"""The one place that chooses a code path from the platform.

Every fill and walk that has more than one implementation asks here:
the GPU fill kernel (ops/gpu_fill.py) or the XLA wavefront
(ops/wavefront.py), and a traceback walked on the device
(ops/device_walk.py) or on the host (native/walker.py). A kernel that
fails raises; nothing falls back to another path.
"""

from __future__ import annotations

import jax

BACKENDS = ("auto", "kernel", "wavefront")


def on_gpu():
    """True when JAX's default device is a GPU."""
    return jax.default_backend() == "gpu"


def use_fill_kernel(backend="auto"):
    """Fill with the GPU kernel (True) or the XLA wavefront (False).

    ``backend``: "auto" takes the kernel on a GPU and XLA elsewhere;
    "kernel" and "wavefront" force one path (A/B runs and the CPU tests,
    where the kernel runs in interpret mode)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "auto":
        return on_gpu()
    return backend == "kernel"


def kernel_interpret():
    """Pallas kernels compile for the GPU; on the CPU (the test suite)
    they run in interpret mode. Any other platform has no kernel route."""
    platform = jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(f"no kernel route for platform {platform!r}")
