"""Row-scan DP fill: `lax.scan` over rows, prefix-max gap linearisation.

This is the reference's parallel strategy (P1 + P2) re-expressed for XLA:
each row's T1/T3 are elementwise in the previous row, and the intra-row T2
recurrence

    T2[i][j] = max(T1[i][j-1] - g - h, T2[i][j-1] - g, T3[i][j-1] - g - h)

is linearised exactly as in the reference (subproblem_alignment.cpp:237-249,
301-325):

    omega[j] = j*g + max(T1[i][j-1], T3[i][j-1]) - g - h
    T2[i][j] = prefix_max(omega)[0..j] - j*g        (omega[0] = T2[i][0])

but with the per-row thread forks replaced by one fused VPU row step and the
pointer-jumping prefix-max by `lax.associative_scan`. All scores are float32
(exact: small integers; -inf absorbing, matching the reference's doubles).

Direction codes are computed during the fill (first-argmax in the
reference's tie order, equivalent to its equality retrace —
subproblem_alignment.cpp:147-169) and packed 2 bits per table into uint8.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from cse305_parallel_sequence_alignment.core import (
    DIR_T1_SHIFT,
    DIR_T2_SHIFT,
    DIR_T3_SHIFT,
    NEG_INF,
    boundary_col0,
    boundary_row0,
)
from cse305_parallel_sequence_alignment.ops.prefix import prefix_max


def _first_argmax3(c1, c2, c3):
    """Index (0/1/2) of the first maximum among three arrays — the
    reference's tie order T1 >= T2 >= T3 (B3)."""
    return jnp.where(
        (c1 >= c2) & (c1 >= c3),
        jnp.uint8(0),
        jnp.where(c2 >= c3, jnp.uint8(1), jnp.uint8(2)),
    )


def _row_step(b_enc, g, h, match, mismatch, n, want_dirs, carry, xs):
    """One DP row: previous row (t1p,t2p,t3p) -> current row (+ dirs)."""
    t1p, t2p, t3p = carry
    a_i, c3_i = xs
    neg_inf = jnp.float32(NEG_INF)
    fb = jnp.where(b_enc == a_i, jnp.float32(match), jnp.float32(mismatch))

    # T1[i][j] = f + max(T1,T2,T3)[i-1][j-1]     (cpp:231)
    diag_max = jnp.maximum(jnp.maximum(t1p[:-1], t2p[:-1]), t3p[:-1])
    t1 = jnp.concatenate([jnp.full((1,), neg_inf), fb + diag_max])

    # T3[i][j] = max(T1-g-h, T2-g-h, T3-g)[i-1][j]   (cpp:232)
    up1, up2, up3 = t1p[1:] - g - h, t2p[1:] - g - h, t3p[1:] - g
    t3 = jnp.concatenate(
        [c3_i[None], jnp.maximum(jnp.maximum(up1, up2), up3)])

    # T2 via prefix-max linearisation (cpp:237-249, 301-325)
    jg = g * jnp.arange(n + 1, dtype=jnp.float32)
    omega_tail = jg[1:] + jnp.maximum(t1[:-1], t3[:-1]) - g - h
    omega = jnp.concatenate([jnp.full((1,), neg_inf), omega_tail])
    t2 = prefix_max(omega) - jg

    if not want_dirs:
        return (t1, t2, t3), None

    d1 = _first_argmax3(t1p[:-1], t2p[:-1], t3p[:-1])
    d3 = _first_argmax3(up1, up2, up3)
    d2 = _first_argmax3(t1[:-1] - g - h, t2[:-1] - g, t3[:-1] - g - h)
    packed = (
        (d1 << DIR_T1_SHIFT) | (d2 << DIR_T2_SHIFT) | (d3 << DIR_T3_SHIFT)
    )
    dirs_row = jnp.concatenate([jnp.zeros((1,), jnp.uint8), packed])
    return (t1, t2, t3), dirs_row


def _init_and_xs(a_enc, b_enc, m, n, g, h, start_type):
    r1, r2, r3 = boundary_row0(n, start_type, g, h)
    c1, c2, c3 = boundary_col0(m, start_type, g, h)
    init = (jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(r3))
    xs = (a_enc.astype(jnp.uint8), jnp.asarray(c3))
    return init, xs


@functools.partial(
    jax.jit, static_argnames=("g", "h", "match", "mismatch", "start_type"))
def rowscan_tables(a_enc, b_enc, g=1.0, h=2.0, match=1.0, mismatch=0.0,
                   start_type=-1):
    """Full (m+1, n+1) T1/T2/T3 tables via row scan (for tests/small runs)."""
    m, n = a_enc.shape[0], b_enc.shape[0]
    init, xs = _init_and_xs(a_enc, b_enc, m, n, g, h, start_type)
    step = functools.partial(
        _row_step, b_enc.astype(jnp.uint8), jnp.float32(g), jnp.float32(h),
        match, mismatch, n, False)

    def step_collect(carry, x):
        carry, _ = step(carry, x)
        return carry, carry

    _, rows = jax.lax.scan(step_collect, init, xs)
    t1 = jnp.concatenate([init[0][None], rows[0]], axis=0)
    t2 = jnp.concatenate([init[1][None], rows[1]], axis=0)
    t3 = jnp.concatenate([init[2][None], rows[2]], axis=0)
    return t1, t2, t3


@functools.partial(
    jax.jit, static_argnames=("g", "h", "match", "mismatch", "start_type"))
def rowscan_dirs(a_enc, b_enc, g=1.0, h=2.0, match=1.0, mismatch=0.0,
                 start_type=-1):
    """Packed direction matrix (m+1, n+1) uint8 + final-cell (T1,T2,T3)."""
    m, n = a_enc.shape[0], b_enc.shape[0]
    init, xs = _init_and_xs(a_enc, b_enc, m, n, g, h, start_type)
    step = functools.partial(
        _row_step, b_enc.astype(jnp.uint8), jnp.float32(g), jnp.float32(h),
        match, mismatch, n, True)
    (t1, t2, t3), dir_rows = jax.lax.scan(step, init, xs)
    dirs = jnp.concatenate(
        [jnp.zeros((1, n + 1), jnp.uint8), dir_rows], axis=0)
    return dirs, jnp.stack([t1[n], t2[n], t3[n]])


@functools.partial(
    jax.jit, static_argnames=("g", "h", "match", "mismatch", "start_type"))
def rowscan_score(a_enc, b_enc, g=1.0, h=2.0, match=1.0, mismatch=0.0,
                  start_type=-1):
    """Final-cell (T1, T2, T3) only — O(n) memory."""
    m, n = a_enc.shape[0], b_enc.shape[0]
    init, xs = _init_and_xs(a_enc, b_enc, m, n, g, h, start_type)
    step = functools.partial(
        _row_step, b_enc.astype(jnp.uint8), jnp.float32(g), jnp.float32(h),
        match, mismatch, n, False)
    (t1, t2, t3), _ = jax.lax.scan(step, init, xs)
    return jnp.stack([t1[n], t2[n], t3[n]])


@functools.partial(
    jax.jit, static_argnames=("g", "h", "match", "mismatch", "start_type"))
def rowscan_lastrow(a_enc, b_enc, g=1.0, h=2.0, match=1.0, mismatch=0.0,
                    start_type=-1):
    """Full last row (3, n+1) of the fill — the partition layer's capture
    primitive (fwd/rev row values at a split row). O(n) memory."""
    m, n = a_enc.shape[0], b_enc.shape[0]
    init, xs = _init_and_xs(a_enc, b_enc, m, n, g, h, start_type)
    step = functools.partial(
        _row_step, b_enc.astype(jnp.uint8), jnp.float32(g), jnp.float32(h),
        match, mismatch, n, False)
    if m == 0:
        return jnp.stack(init)
    (t1, t2, t3), _ = jax.lax.scan(step, init, xs)
    return jnp.stack([t1, t2, t3])
