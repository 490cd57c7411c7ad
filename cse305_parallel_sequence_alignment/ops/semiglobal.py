"""Batched semi-global ("glocal") alignment fill: A end-to-end, B free ends.

Part of the framework's model-family surface (the reference implements
global only). Semantics:

- the query A must be consumed completely; the target B contributes a free
  prefix and suffix (no cost for unaligned B flanks);
- boundaries: T1[0][j] = 0 for every j (start after any B prefix);
  column 0 carries normal gap costs (leading gaps in B are paid, as A must
  align); T2/T3 row-0 boundaries are -inf;
- the result is the best cell in row m over any column j (ending before
  any B suffix), tie order T1 >= T2 >= T3 then smallest j.

Same anti-diagonal wavefront design as ops/wavefront.py; direction codes
are the global 2-bit codes (the walk terminates at row 0).
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

_BIG_J = 2.0 ** 24


def _sg_single(a_enc, b_enc, len_a, len_b, g, h, match, mismatch,
               want_dirs):
    """One pair. Returns best (4,): [score, table, end_i, end_j]
    (+ dirs)."""
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
    neg_row = jnp.full((n + 1,), neg_inf)
    # d = 0: corner; row 0 of T1 is all zeros (free B prefix)
    diag0 = (jnp.where(jj == 0, 0.0, neg_inf), neg_row, neg_row)

    def col0_t3(i):
        return -h - g * i.astype(jnp.float32)

    def step(carry, d):
        (p1, p2, p3), (q1, q2, q3), best = carry
        ii = d - jj
        interior = (jj >= 1) & (ii >= 1) & (ii <= m)
        on_row0 = ii == 0
        on_col0 = (jj == 0) & (ii >= 1) & (ii <= m)
        valid = (ii >= 0) & (ii <= m)

        av = jax.lax.dynamic_slice(arev_pad, (m - d + n + 1,), (n + 1,))
        fvec = jnp.where(av == b_ext,
                         jnp.float32(match), jnp.float32(mismatch))

        s1, s2, s3 = (_shift_right(q1), _shift_right(q2), _shift_right(q3))
        t1_int = fvec + jnp.maximum(jnp.maximum(s1, s2), s3)

        l1, l2, l3 = (_shift_right(p1), _shift_right(p2), _shift_right(p3))
        c2a, c2b, c2c = l1 - g - h, l2 - g, l3 - g - h
        t2_int = jnp.maximum(jnp.maximum(c2a, c2b), c2c)

        c3a, c3b, c3c = p1 - g - h, p2 - g - h, p3 - g
        t3_int = jnp.maximum(jnp.maximum(c3a, c3b), c3c)

        t1 = jnp.where(on_row0, 0.0, jnp.where(interior, t1_int, neg_inf))
        t2 = jnp.where(interior, t2_int, neg_inf)
        t3 = jnp.where(on_col0, col0_t3(jnp.minimum(d, m)),
                       jnp.where(interior, t3_int, neg_inf))
        t1 = jnp.where(valid, t1, neg_inf)
        t2 = jnp.where(valid, t2, neg_inf)
        t3 = jnp.where(valid, t3, neg_inf)

        # best over row len_a, columns 1..len_b, tables T1 >= T2 >= T3
        onrow = (ii == len_a) & (jj >= 1) & (jj <= len_b)
        cv1 = jnp.max(jnp.where(onrow, t1, neg_inf))
        cv2 = jnp.max(jnp.where(onrow, t2, neg_inf))
        cv3 = jnp.max(jnp.where(onrow, t3, neg_inf))
        cv = jnp.maximum(jnp.maximum(cv1, cv2), cv3)
        ct = jnp.where(cv1 >= cv, 1,
                       jnp.where(cv2 >= cv, 2, 3)).astype(jnp.float32)
        row = jnp.where(ct == 1, t1, jnp.where(ct == 2, t2, t3))
        jf = jj.astype(jnp.float32)
        cj = jnp.min(jnp.where(onrow & (row == cv), jf, _BIG_J))
        better = cv > best[0]
        best = (jnp.where(better, cv, best[0]),
                jnp.where(better, ct, best[1]),
                jnp.where(better, cj, best[2]))

        if want_dirs:
            d1 = _first_argmax3(s1, s2, s3)
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
    best0 = (jnp.float32(NEG_INF), jnp.float32(1), jnp.float32(0))
    carry0 = (diag0, (neg_row, neg_row, neg_row), best0)
    (_, _, best), dirs_rows = jax.lax.scan(step, carry0, ds)
    out = jnp.stack([best[0], best[1],
                     len_a.astype(jnp.float32), best[2]])
    if want_dirs:
        dirs = jnp.concatenate(
            [jnp.zeros((1, n + 1), jnp.uint8), dirs_rows], axis=0)
        return out, dirs
    return out


@functools.partial(
    jax.jit, static_argnames=("g", "h", "match", "mismatch"))
def semiglobal_score_batch(a_enc, b_enc, len_a, len_b, g=1.0, h=2.0,
                           match=1.0, mismatch=0.0):
    """Batched semi-global fill. Returns (B, 4): [score, end_table,
    end_i (= len_a), end_j]."""
    fn = functools.partial(
        _sg_single, g=g, h=h, match=match, mismatch=mismatch,
        want_dirs=False)
    return jax.vmap(fn)(a_enc, b_enc, len_a, len_b)


@functools.partial(
    jax.jit, static_argnames=("g", "h", "match", "mismatch"))
def semiglobal_dirs_batch(a_enc, b_enc, len_a, len_b, g=1.0, h=2.0,
                          match=1.0, mismatch=0.0):
    """Batched semi-global fill emitting skewed packed directions."""
    fn = functools.partial(
        _sg_single, g=g, h=h, match=match, mismatch=mismatch,
        want_dirs=True)
    return jax.vmap(fn)(a_enc, b_enc, len_a, len_b)
