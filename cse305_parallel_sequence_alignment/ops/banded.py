"""Banded affine-gap global alignment: O(m * W) fill.

A production optimization the reference lacks: when the optimal path is
known to stay near the main diagonal (similar-length, similar-content
pairs — e.g. the reference dataset's gene pairs), restricting the DP to a
diagonal band of width W makes the fill O(m*W) instead of O(m*n).

Band parameterization: lane l in [0, W) of row i holds cell
j = i - w_lo + l (the window shifts one column right per row). This makes
the dependencies static:

- diagonal (i-1, j-1) -> same lane of the previous row,
- up       (i-1, j)   -> lane l+1 of the previous row,
- left     (i,   j-1) -> lane l-1 of the same row: resolved with the
  prefix-max linearization (reference P2) over the window, seeded -inf at
  the band edge.

The band must contain (0, 0) and (m, n): w_lo >= 0 bounds i-j from above
by w_lo, and w_hi >= n - m (lane of (m, n) must exist). ``band_check``
validates. Scores float32 (exact), boundaries as core.boundary_*.

Direction matrices are (m+1, W) packed bytes in band coordinates;
``traceback_banded_from_dirs`` (ops/traceback.py) walks them.
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
    boundary_row0,
)
from cse305_parallel_sequence_alignment.ops.wavefront import (
    PAD_B,
    _first_argmax3,
)


def band_check(m, n, w_lo, w_hi):
    """Raise unless the band [i-w_lo, i+w_hi] covers (0,0) and (m,n)."""
    if w_lo < 0 or w_hi < 0:
        raise ValueError("band widths must be non-negative")
    if n - m > w_hi:
        raise ValueError(
            f"band upper width {w_hi} misses (m, n): need >= {n - m}")
    if m - n > w_lo:
        raise ValueError(
            f"band lower width {w_lo} misses (m, n): need >= {m - n}")


def _banded_single(a_enc, b_ext, g, h, match, mismatch, start_type,
                   w_lo, W, n, want_dirs):
    """One pair banded fill. b_ext: (n+1+W+2,) padded B with sentinel
    slot 0 ('-') and PAD tail; returns final (3,) at (m, n) (+ dirs)."""
    m = a_enc.shape[0]
    neg_inf = jnp.float32(NEG_INF)
    gf, hf = jnp.float32(g), jnp.float32(h)
    g_py, h_py = float(g), float(h)

    ll = jnp.arange(W, dtype=jnp.int32)

    # row 0: lanes l with j = -w_lo + l in [0, n]
    r1, r2, r3 = boundary_row0(n, start_type, g_py, h_py)
    row0_full = (jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(r3))
    j_row0 = ll - w_lo
    in0 = (j_row0 >= 0) & (j_row0 <= n)
    j0c = jnp.clip(j_row0, 0, n)
    row0 = tuple(jnp.where(in0, t[j0c], neg_inf) for t in row0_full)

    def col0_t3(i):
        if start_type == -3:
            return -gf * i
        if start_type in (1, 2):
            return neg_inf
        return -hf - gf * i

    def step(carry, xs):
        p1, p2, p3 = carry
        a_i, i = xs
        j_lane = i - w_lo + ll                      # global j per lane
        inband = (j_lane >= 1) & (j_lane <= n)
        on_col0 = j_lane == 0
        jf = j_lane.astype(jnp.float32)

        bv = jax.lax.dynamic_slice(b_ext, (i - w_lo + W,), (W,))
        fvec = jnp.where(bv == a_i, jnp.float32(match),
                         jnp.float32(mismatch))

        # diag = same lane; up = lane+1 (shift left, -inf fill)
        u1 = jnp.concatenate([p1[1:], jnp.full((1,), neg_inf)])
        u2 = jnp.concatenate([p2[1:], jnp.full((1,), neg_inf)])
        u3 = jnp.concatenate([p3[1:], jnp.full((1,), neg_inf)])

        t1_int = fvec + jnp.maximum(jnp.maximum(p1, p2), p3)
        c3a, c3b, c3c = u1 - gf - hf, u2 - gf - hf, u3 - gf
        t3_int = jnp.maximum(jnp.maximum(c3a, c3b), c3c)
        t1 = jnp.where(inband, t1_int, neg_inf)
        t3 = jnp.where(on_col0, col0_t3(jnp.float32(i)),
                       jnp.where(inband, t3_int, neg_inf))

        # T2 via in-window prefix-max with global offsets; column 0's
        # boundary T2 is -inf (boundary_col0), so the seed is -inf and
        # lanes left of the band contribute nothing.
        mvec = jnp.maximum(t1, t3)
        m_prev = jnp.concatenate([jnp.full((1,), neg_inf), mvec[:-1]])
        omega = jnp.where(inband, jf * gf + m_prev - gf - hf, neg_inf)
        pm = jax.lax.associative_scan(jnp.maximum, omega)
        t2 = jnp.where(inband, pm - jf * gf, neg_inf)

        if want_dirs:
            d1 = _first_argmax3(p1, p2, p3)
            # left-cell values for T2's code: lane l-1 of this row
            l1 = jnp.concatenate([jnp.full((1,), neg_inf), t1[:-1]])
            l2 = jnp.concatenate([jnp.full((1,), neg_inf), t2[:-1]])
            l3 = jnp.concatenate([jnp.full((1,), neg_inf), t3[:-1]])
            d2 = _first_argmax3(l1 - gf - hf, l2 - gf, l3 - gf - hf)
            d3 = _first_argmax3(c3a, c3b, c3c)
            packed = jnp.where(
                inband,
                (d1 << DIR_T1_SHIFT) | (d2 << DIR_T2_SHIFT)
                | (d3 << DIR_T3_SHIFT),
                jnp.uint8(0))
        else:
            packed = None
        return (t1, t2, t3), packed

    xs = (a_enc, jnp.arange(1, m + 1, dtype=jnp.int32))
    (f1, f2, f3), dirs_rows = jax.lax.scan(step, row0, xs)
    lane_mn = n - m + w_lo
    finals = jnp.stack([f1[lane_mn], f2[lane_mn], f3[lane_mn]])
    if want_dirs:
        dirs = jnp.concatenate(
            [jnp.zeros((1, W), jnp.uint8), dirs_rows], axis=0)
        return finals, dirs
    return finals


def _prep_b(b_enc, n, w_lo, W):
    """Sentinel+padded B so the per-row window slice is always in range:
    index (j + W) holds B[j-1] for j>=1, '-' at j==0, PAD outside."""
    ext = np.full((n + 1 + W + W + 2,), PAD_B, np.uint8)
    ext[W] = ord("-")
    ext[W + 1: W + 1 + n] = np.asarray(b_enc, np.uint8)
    return ext


@functools.partial(
    jax.jit,
    static_argnames=("g", "h", "match", "mismatch", "start_type", "w_lo",
                     "W", "n"))
def _banded_score_jit(a_enc, b_ext, g, h, match, mismatch, start_type,
                      w_lo, W, n):
    return _banded_single(a_enc, b_ext, g, h, match, mismatch, start_type,
                          w_lo, W, n, want_dirs=False)


@functools.partial(
    jax.jit,
    static_argnames=("g", "h", "match", "mismatch", "start_type", "w_lo",
                     "W", "n"))
def _banded_dirs_jit(a_enc, b_ext, g, h, match, mismatch, start_type,
                     w_lo, W, n):
    return _banded_single(a_enc, b_ext, g, h, match, mismatch, start_type,
                          w_lo, W, n, want_dirs=True)


def banded_score(a_enc, b_enc, w_lo, w_hi, g=1.0, h=2.0, match=1.0,
                 mismatch=0.0, start_type=-1):
    """Final-cell (3,) values of the banded fill."""
    a_enc = np.asarray(a_enc, np.uint8)
    b_enc = np.asarray(b_enc, np.uint8)
    m, n = a_enc.shape[0], b_enc.shape[0]
    band_check(m, n, w_lo, w_hi)
    W = w_lo + w_hi + 1
    b_ext = _prep_b(b_enc, n, w_lo, W)
    return np.asarray(_banded_score_jit(
        jnp.asarray(a_enc), jnp.asarray(b_ext), g, h, match, mismatch,
        start_type, w_lo, W, n))


@functools.partial(
    jax.jit,
    static_argnames=("g", "h", "match", "mismatch", "start_type", "w_lo",
                     "W", "n"))
def _banded_score_batch_jit(a_enc, b_ext, g, h, match, mismatch,
                            start_type, w_lo, W, n):
    fn = functools.partial(
        _banded_single, g=g, h=h, match=match, mismatch=mismatch,
        start_type=start_type, w_lo=w_lo, W=W, n=n, want_dirs=False)
    return jax.vmap(fn)(a_enc, b_ext)


def banded_score_batch(a_enc, b_enc, w_lo, w_hi, g=1.0, h=2.0, match=1.0,
                       mismatch=0.0, start_type=-1):
    """Batched banded fill: (B, m) x (B, n) equal-shape pairs -> (B, 3)
    finals. All pairs share the band and true lengths (pad-free fast
    path for uniform similar-pair workloads)."""
    a_enc = np.asarray(a_enc, np.uint8)
    b_enc = np.asarray(b_enc, np.uint8)
    B, m = a_enc.shape
    n = b_enc.shape[1]
    band_check(m, n, w_lo, w_hi)
    W = w_lo + w_hi + 1
    b_ext = np.stack([_prep_b(b_enc[k], n, w_lo, W) for k in range(B)])
    return np.asarray(_banded_score_batch_jit(
        jnp.asarray(a_enc), jnp.asarray(b_ext), g, h, match, mismatch,
        start_type, w_lo, W, n))


def banded_dirs(a_enc, b_enc, w_lo, w_hi, g=1.0, h=2.0, match=1.0,
                mismatch=0.0, start_type=-1):
    """(finals (3,), dirs (m+1, W) packed band-coordinate bytes)."""
    a_enc = np.asarray(a_enc, np.uint8)
    b_enc = np.asarray(b_enc, np.uint8)
    m, n = a_enc.shape[0], b_enc.shape[0]
    band_check(m, n, w_lo, w_hi)
    W = w_lo + w_hi + 1
    b_ext = _prep_b(b_enc, n, w_lo, W)
    finals, dirs = _banded_dirs_jit(
        jnp.asarray(a_enc), jnp.asarray(b_ext), g, h, match, mismatch,
        start_type, w_lo, W, n)
    return np.asarray(finals), np.asarray(dirs)
