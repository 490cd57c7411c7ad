"""Batched Smith-Waterman local alignment fill (affine gaps, wavefront).

The reference implements only global alignment; local mode is part of this
framework's capability surface (BASELINE.json config 3: affine-gap SW with
traceback CIGARs). Same anti-diagonal design as ops/wavefront.py:

- three-table affine recurrence, with T1 clamped at zero (a local alignment
  may start fresh at any cell):
      T1[i][j] = max(0, f(i,j) + max(T1,T2,T3)[i-1][j-1])
      T2/T3 as in the global engine, -inf boundaries
- the running best T1 cell (value, diagonal, column) is tracked in the scan
  carry, masked to each pair's true lengths (ragged batches share a padded
  bucket);
- direction matrices use the same 2-bit/table packing; T1's code 3 marks
  "local start here" (the clamp won), which is the traceback terminator.

Scores are float32 (exact for integer scoring). Layout "skew": cell (i, j)
of the dirs matrix lives at [i + j, j].
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cse305_parallel_sequence_alignment.core import (
    DIR_T1_SHIFT,
    DIR_T2_SHIFT,
    DIR_T3_SHIFT,
    NEG_INF,
)
from cse305_parallel_sequence_alignment.ops.wavefront import (
    PAD_A,
    PAD_B,
    _first_argmax3,
    _shift_right,
)

DIR_LOCAL_START = 3  # T1 direction code: alignment starts at this cell


def _sw_single(a_enc, b_enc, len_a, len_b, g, h, match, mismatch,
               want_dirs):
    """One pair, local-mode scan over anti-diagonals.

    Returns (best (3,): [value, i, j]) and optionally the packed dirs
    (m+n+1, n+1) uint8.
    """
    m, n = a_enc.shape[0], b_enc.shape[0]
    neg_inf = jnp.float32(NEG_INF)
    g = jnp.float32(g)
    h = jnp.float32(h)

    arev = a_enc[::-1]
    arev_pad = jnp.concatenate([
        jnp.full((n + 1,), PAD_A, jnp.uint8), arev,
        jnp.full((n + 1,), PAD_A, jnp.uint8)])
    b_ext = jnp.concatenate([jnp.full((1,), PAD_B, jnp.uint8), b_enc])

    jj = jnp.arange(n + 1, dtype=jnp.int32)
    zero_row = jnp.zeros((n + 1,), jnp.float32)
    neg_row = jnp.full((n + 1,), neg_inf)

    # diagonal d=0: T1 = 0 at the corner (row/col 0 are all zero in SW)
    diag0 = (jnp.where(jj == 0, 0.0, neg_inf), neg_row, neg_row)

    def step(carry, d):
        (p1, p2, p3), (q1, q2, q3), best = carry
        ii = d - jj
        interior = (jj >= 1) & (ii >= 1) & (ii <= m)
        inlen = interior & (jj <= len_b) & (ii <= len_a)
        on_edge = ((ii == 0) | (jj == 0)) & (ii >= 0) & (ii <= m)

        av = jax.lax.dynamic_slice(arev_pad, (m - d + n + 1,), (n + 1,))
        fvec = jnp.where(av == b_ext,
                         jnp.float32(match), jnp.float32(mismatch))

        s1, s2, s3 = (_shift_right(q1), _shift_right(q2), _shift_right(q3))
        t1_open = fvec + jnp.maximum(jnp.maximum(s1, s2), s3)
        t1_int = jnp.maximum(t1_open, 0.0)

        l1, l2, l3 = (_shift_right(p1), _shift_right(p2), _shift_right(p3))
        c2a, c2b, c2c = l1 - g - h, l2 - g, l3 - g - h
        t2_int = jnp.maximum(jnp.maximum(c2a, c2b), c2c)

        c3a, c3b, c3c = p1 - g - h, p2 - g - h, p3 - g
        t3_int = jnp.maximum(jnp.maximum(c3a, c3b), c3c)

        t1 = jnp.where(on_edge, 0.0, jnp.where(interior, t1_int, neg_inf))
        t2 = jnp.where(interior, t2_int, neg_inf)
        t3 = jnp.where(interior, t3_int, neg_inf)

        # running best over T1, restricted to in-length cells; ties keep
        # the earliest (smallest d, then smallest j) — deterministic
        cand = jnp.where(inlen, t1, neg_inf)
        cj = jnp.argmax(cand)
        cv = cand[cj]
        better = cv > best[0]
        best = (jnp.where(better, cv, best[0]),
                jnp.where(better, d - cj, best[1]),
                jnp.where(better, cj, best[2]))

        if want_dirs:
            # stop at the first zero: a 0-valued open is a fresh start,
            # never a zero-score extension of a longer chain
            d1 = jnp.where(t1_open > 0.0,
                           _first_argmax3(s1, s2, s3),
                           jnp.uint8(DIR_LOCAL_START))
            d2 = _first_argmax3(c2a, c2b, c2c)
            d3 = _first_argmax3(c3a, c3b, c3c)
            packed = jnp.where(
                interior,
                (d1 << DIR_T1_SHIFT) | (d2 << DIR_T2_SHIFT)
                | (d3 << DIR_T3_SHIFT),
                jnp.uint8(0),
            )
        else:
            packed = None
        return (((t1, t2, t3), (p1, p2, p3), best), packed)

    ds = jnp.arange(1, m + n + 1, dtype=jnp.int32)
    best0 = (jnp.float32(0.0), jnp.int32(0), jnp.int32(0))
    carry0 = (diag0, (neg_row, neg_row, neg_row), best0)
    (_, _, best), dirs_rows = jax.lax.scan(step, carry0, ds)
    out_best = jnp.stack([best[0], best[1].astype(jnp.float32),
                          best[2].astype(jnp.float32)])
    if want_dirs:
        dirs = jnp.concatenate(
            [jnp.zeros((1, n + 1), jnp.uint8), dirs_rows], axis=0)
        return out_best, dirs
    return out_best


@functools.partial(
    jax.jit, static_argnames=("g", "h", "match", "mismatch"))
def sw_score_batch(a_enc, b_enc, len_a, len_b, g=1.0, h=2.0, match=2.0,
                   mismatch=-1.0):
    """Batched local scores. Returns (B, 3): [best, end_i, end_j]."""
    fn = functools.partial(
        _sw_single, g=g, h=h, match=match, mismatch=mismatch,
        want_dirs=False)
    return jax.vmap(fn)(a_enc, b_enc, len_a, len_b)


@functools.partial(
    jax.jit, static_argnames=("g", "h", "match", "mismatch"))
def sw_dirs_batch(a_enc, b_enc, len_a, len_b, g=1.0, h=2.0, match=2.0,
                  mismatch=-1.0):
    """Batched local fill emitting skewed packed direction matrices.

    Returns (best (B, 3), dirs (B, m+n+1, n+1) uint8, layout 'skew')."""
    fn = functools.partial(
        _sw_single, g=g, h=h, match=match, mismatch=mismatch,
        want_dirs=True)
    return jax.vmap(fn)(a_enc, b_enc, len_a, len_b)
