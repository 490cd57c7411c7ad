"""Batched anti-diagonal wavefront DP fill (pure JAX).

The device replacement for the reference's thread-per-row fill (P1):
sweep the DP matrix by anti-diagonals d = i + j. Every cell on a diagonal
depends only on diagonals d-1 (T2: left, T3: up) and d-2 (T1: diag), so a
whole diagonal is one fused elementwise step — no prefix-max needed and
no intra-step dependency at all. Batches of pairs are processed in lockstep
(vmap over the leading axis), so each step spans batch x diagonal.

Diagonal storage is "skewed": a diagonal is indexed by column j, cell (i, j)
living at slot j of diagonal i + j. Packed direction matrices are emitted in
this skewed layout, (m+n+1, n+1) uint8, read back as dirs[i+j, j]
(ops/traceback.py handles it).

Semantics (boundaries, tie order, scores) are identical to ops/rowscan.py
and the reference engine; tests assert table equality cell-by-cell.
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

# Padding codes guaranteed never to match real sequence bytes or each other.
PAD_A = np.uint8(254)
PAD_B = np.uint8(255)


def _first_argmax3(c1, c2, c3):
    return jnp.where(
        (c1 >= c2) & (c1 >= c3),
        jnp.uint8(0),
        jnp.where(c2 >= c3, jnp.uint8(1), jnp.uint8(2)),
    )


def _shift_right(x, fill=NEG_INF):
    """[x0..xk] -> [fill, x0..x(k-1)] along the last axis."""
    return jnp.concatenate(
        [jnp.full(x.shape[:-1] + (1,), fill, x.dtype), x[..., :-1]], axis=-1)


def _wavefront_single(a_enc, b_enc, len_a, len_b, g, h, match, mismatch,
                      start_type, want_dirs, submat=None, pad_a=PAD_A,
                      pad_b=PAD_B):
    """One pair, scan over anti-diagonals. a_enc: (m,), b_enc: (n,) uint8.

    len_a/len_b select where the final cell is captured, so ragged pairs
    can share one padded bucket shape. With ``submat`` (a traced
    (K+1, K+1) lookup, core.SubstitutionMatrix.table()), sequences are
    alphabet codes with pad code K and f(a, b) = submat[a, b]; otherwise
    raw bytes with the static match/mismatch rule.
    """
    m, n = a_enc.shape[0], b_enc.shape[0]
    neg_inf = jnp.float32(NEG_INF)
    g_py, h_py = float(g), float(h)
    g = jnp.float32(g)
    h = jnp.float32(h)

    # Reversed-A gather trick: v[j] = a[d-j-1] = arev[m-d+j]; one dynamic
    # slice per diagonal instead of a gather.
    arev = a_enc[::-1]
    arev_pad = jnp.concatenate([
        jnp.full((n + 1,), pad_a, jnp.uint8), arev,
        jnp.full((n + 1,), pad_a, jnp.uint8)])
    b_ext = jnp.concatenate([jnp.full((1,), pad_b, jnp.uint8), b_enc])
    if submat is not None:
        submat_flat = submat.reshape(-1)
        k1 = submat.shape[0]

    # Static boundary tables.
    r1, r2, r3 = boundary_row0(n, start_type, g_py, h_py)
    row0 = (jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(r3))
    _, _, c3 = boundary_col0(m, start_type, g_py, h_py)
    corner3 = r3[0]
    col0_t3 = jnp.concatenate(
        [jnp.asarray([corner3], jnp.float32), jnp.asarray(c3)])  # index i

    jj = jnp.arange(n + 1, dtype=jnp.int32)

    diag0 = tuple(
        jnp.where(jj == 0, t[0], neg_inf).astype(jnp.float32) for t in row0)
    diag_neg = tuple(jnp.full((n + 1,), neg_inf) for _ in range(3))
    finals0 = jnp.stack([row0[0][0], row0[1][0], row0[2][0]])

    def step(carry, d):
        (p1, p2, p3), (q1, q2, q3), finals = carry
        # p* = diagonal d-1, q* = diagonal d-2
        ii = d - jj
        interior = (jj >= 1) & (ii >= 1) & (ii <= m)
        on_row0 = ii == 0
        on_col0 = (jj == 0) & (ii >= 1) & (ii <= m)
        valid = (ii >= 0) & (ii <= m)

        av = jax.lax.dynamic_slice(arev_pad, (m - d + n + 1,), (n + 1,))
        if submat is None:
            fvec = jnp.where(av == b_ext,
                             jnp.float32(match), jnp.float32(mismatch))
        else:
            fvec = submat_flat[av.astype(jnp.int32) * k1
                               + b_ext.astype(jnp.int32)]

        s1, s2, s3 = (_shift_right(q1), _shift_right(q2), _shift_right(q3))
        t1_int = fvec + jnp.maximum(jnp.maximum(s1, s2), s3)

        l1, l2, l3 = (_shift_right(p1), _shift_right(p2), _shift_right(p3))
        c2a, c2b, c2c = l1 - g - h, l2 - g, l3 - g - h
        t2_int = jnp.maximum(jnp.maximum(c2a, c2b), c2c)

        c3a, c3b, c3c = p1 - g - h, p2 - g - h, p3 - g
        t3_int = jnp.maximum(jnp.maximum(c3a, c3b), c3c)

        col0_val = col0_t3[jnp.minimum(d, m)]
        t1 = jnp.where(on_row0, row0[0], jnp.where(
            interior, t1_int, neg_inf))
        t2 = jnp.where(on_row0, row0[1], jnp.where(
            interior, t2_int, neg_inf))
        t3 = jnp.where(on_row0, row0[2], jnp.where(
            on_col0, col0_val, jnp.where(interior, t3_int, neg_inf)))
        t1 = jnp.where(valid, t1, neg_inf)
        t2 = jnp.where(valid, t2, neg_inf)
        t3 = jnp.where(valid, t3, neg_inf)

        cap = d == len_a + len_b
        new_finals = jnp.where(
            cap,
            jnp.stack([t1[len_b], t2[len_b], t3[len_b]]),
            finals)

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
        return (((t1, t2, t3), (p1, p2, p3), new_finals), packed)

    ds = jnp.arange(1, m + n + 1, dtype=jnp.int32)
    carry0 = (diag0, diag_neg, finals0)
    (last, _, finals), dirs_rows = jax.lax.scan(step, carry0, ds)
    if want_dirs:
        dirs = jnp.concatenate(
            [jnp.zeros((1, n + 1), jnp.uint8), dirs_rows], axis=0)
        return finals, dirs
    return finals


@functools.partial(
    jax.jit,
    static_argnames=("g", "h", "match", "mismatch", "start_type"))
def wavefront_score_batch(a_enc, b_enc, len_a, len_b, g=1.0, h=2.0,
                          match=1.0, mismatch=0.0, start_type=-1):
    """Batched score-only fill. a_enc: (B, m), b_enc: (B, n) uint8 padded;
    len_a/len_b: (B,) int32. Returns (B, 3) final-cell (T1, T2, T3)."""
    fn = functools.partial(
        _wavefront_single, g=g, h=h, match=match, mismatch=mismatch,
        start_type=start_type, want_dirs=False)
    return jax.vmap(fn)(a_enc, b_enc, len_a, len_b)


@functools.partial(
    jax.jit,
    static_argnames=("g", "h", "match", "mismatch", "start_type"))
def wavefront_dirs_batch(a_enc, b_enc, len_a, len_b, g=1.0, h=2.0,
                         match=1.0, mismatch=0.0, start_type=-1):
    """Batched fill emitting skewed packed direction matrices.

    Returns (finals (B, 3), dirs (B, m+n+1, n+1) uint8, layout 'skew')."""
    fn = functools.partial(
        _wavefront_single, g=g, h=h, match=match, mismatch=mismatch,
        start_type=start_type, want_dirs=True)
    return jax.vmap(fn)(a_enc, b_enc, len_a, len_b)


@functools.partial(
    jax.jit, static_argnames=("g", "h", "start_type", "pad_code"))
def wavefront_score_batch_matrix(a_codes, b_codes, len_a, len_b, submat,
                                 g=1.0, h=2.0, start_type=-1,
                                 pad_code=255):
    """Batched score-only fill under a substitution matrix.

    ``a_codes``/``b_codes``: (B, m)/(B, n) uint8 alphabet codes padded
    with ``pad_code``; ``submat``: (K+1, K+1) float32 lookup
    (core.SubstitutionMatrix.table()). Returns (B, 3)."""
    fn = functools.partial(
        _wavefront_single, g=g, h=h, match=0.0, mismatch=0.0,
        start_type=start_type, want_dirs=False,
        pad_a=np.uint8(pad_code), pad_b=np.uint8(pad_code))
    return jax.vmap(
        lambda a, b, la, lb, sm: fn(a, b, la, lb, submat=sm),
        in_axes=(0, 0, 0, 0, None))(
        a_codes, b_codes, len_a, len_b, submat)


@functools.partial(
    jax.jit, static_argnames=("g", "h", "start_type", "pad_code"))
def wavefront_dirs_batch_matrix(a_codes, b_codes, len_a, len_b, submat,
                                g=1.0, h=2.0, start_type=-1,
                                pad_code=255):
    """Batched substitution-matrix fill emitting skewed packed dirs."""
    fn = functools.partial(
        _wavefront_single, g=g, h=h, match=0.0, mismatch=0.0,
        start_type=start_type, want_dirs=True,
        pad_a=np.uint8(pad_code), pad_b=np.uint8(pad_code))
    return jax.vmap(
        lambda a, b, la, lb, sm: fn(a, b, la, lb, submat=sm),
        in_axes=(0, 0, 0, 0, None))(
        a_codes, b_codes, len_a, len_b, submat)
