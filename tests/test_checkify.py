"""Device-code sanitizer pass (SURVEY §5 race/sanitizer row): run the
representative fill kernels under jax.experimental.checkify with the
full automatic-check set (out-of-bounds indexing, NaN generation,
division) and assert the functional error value is clean.

XLA device code is race-free by construction; what CAN go wrong is
index arithmetic (gathers in the fills and the device walk) and NaN
from -inf arithmetic — exactly what checkify instruments.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import checkify

from cse305_parallel_sequence_alignment.ops.device_walk import (
    _device_walk,
)
from cse305_parallel_sequence_alignment.ops.wavefront import (
    PAD_A,
    PAD_B,
    wavefront_dirs_batch,
    wavefront_score_batch,
)

CHECKS = checkify.index_checks | checkify.nan_checks | checkify.div_checks


def _batch(rng, B, bm, bn):
    a = np.full((B, bm), PAD_A, np.uint8)
    b = np.full((B, bn), PAD_B, np.uint8)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    for k in range(B):
        la[k] = int(rng.integers(0, bm + 1))  # includes empty sequences
        lb[k] = int(rng.integers(0, bn + 1))
        a[k, : la[k]] = rng.integers(65, 69, la[k])
        b[k, : lb[k]] = rng.integers(65, 69, lb[k])
    return (jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
            jnp.asarray(lb))


def test_checkify_wavefront_score():
    rng = np.random.default_rng(51)
    args = _batch(rng, 8, 24, 30)
    checked = checkify.checkify(
        lambda *xs: wavefront_score_batch(*xs), errors=CHECKS)
    err, out = jax.jit(checked)(*args)
    err.throw()  # clean = no-op
    assert np.all(np.isfinite(np.asarray(out)[:, 0]) |
                  (np.asarray(args[2]) == 0) | (np.asarray(args[3]) == 0))


def test_checkify_dirs_and_device_walk():
    rng = np.random.default_rng(53)
    a, b, la, lb = _batch(rng, 6, 20, 25)
    la = jnp.maximum(la, 1)
    lb = jnp.maximum(lb, 1)
    checked = checkify.checkify(
        lambda *xs: wavefront_dirs_batch(*xs), errors=CHECKS)
    err, (finals, dirs) = jax.jit(checked)(a, b, la, lb)
    err.throw()

    walk = checkify.checkify(
        lambda d, i0, j0, t0: _device_walk(d, i0, j0, t0, max_steps=46),
        errors=checkify.index_checks | checkify.div_checks)
    err2, ops = jax.jit(walk)(dirs, la.astype(jnp.int32),
                              lb.astype(jnp.int32),
                              jnp.ones_like(la, jnp.int32))
    err2.throw()
    assert np.asarray(ops).shape[1] == 46
