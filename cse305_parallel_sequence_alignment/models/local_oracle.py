"""Serial numpy Smith-Waterman oracle (affine gaps) for testing ops/local.

The reference has no local mode; semantics here are the framework's own
(documented in ops/local.py): T1 clamped at zero, best over T1, traceback
stops at the first zero cell, tie order T1 >= T2 >= T3 matching the global
engine's direction codes.
"""

from __future__ import annotations

import numpy as np

from cse305_parallel_sequence_alignment.core import (
    NEG_INF,
    ScoringParams,
    encode_seq,
)

LOCAL_PARAMS = ScoringParams(g=1.0, h=2.0, match=2.0, mismatch=-1.0)


def sw_oracle_tables(a, b, params=LOCAL_PARAMS):
    a = encode_seq(a) if isinstance(a, (str, bytes)) else np.asarray(a)
    b = encode_seq(b) if isinstance(b, (str, bytes)) else np.asarray(b)
    m, n = len(a), len(b)
    g, h, match, mismatch = params.astuple()

    T1 = np.zeros((m + 1, n + 1), np.float32)
    T2 = np.full((m + 1, n + 1), NEG_INF, np.float32)
    T3 = np.full((m + 1, n + 1), NEG_INF, np.float32)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            f = match if a[i - 1] == b[j - 1] else mismatch
            T1[i, j] = max(0.0, f + max(T1[i - 1, j - 1], T2[i - 1, j - 1],
                                        T3[i - 1, j - 1]))
            T3[i, j] = max(T1[i - 1, j] - g - h, T2[i - 1, j] - g - h,
                           T3[i - 1, j] - g)
            T2[i, j] = max(T1[i, j - 1] - g - h, T2[i, j - 1] - g,
                           T3[i, j - 1] - g - h)
    return T1, T2, T3


def sw_oracle_best(a, b, params=LOCAL_PARAMS):
    """(best_score, end_i, end_j) with first-cell tie-break in row-major
    order of (i + j, j) — matching the wavefront's earliest-diagonal rule."""
    T1, _, _ = sw_oracle_tables(a, b, params)
    m, n = T1.shape[0] - 1, T1.shape[1] - 1
    best, bi, bj = 0.0, 0, 0
    for d in range(0, m + n + 1):
        for j in range(max(0, d - m), min(n, d) + 1):
            i = d - j
            if T1[i, j] > best:
                best, bi, bj = float(T1[i, j]), i, j
    return best, bi, bj


def sw_oracle_align(a, b, params=LOCAL_PARAMS):
    """(score, chain) by value-retrace from the best cell."""
    a_enc = encode_seq(a) if isinstance(a, (str, bytes)) else np.asarray(a)
    b_enc = encode_seq(b) if isinstance(b, (str, bytes)) else np.asarray(b)
    g, h, match, mismatch = params.astuple()
    T1, T2, T3 = sw_oracle_tables(a_enc, b_enc, params)
    best, i, j = sw_oracle_best(a_enc, b_enc, params)
    if best == 0.0:
        return 0.0, []

    def f(i, j):
        return match if a_enc[i - 1] == b_enc[j - 1] else mismatch

    rev = []
    t = 1
    while True:
        rev.append((i, j, 1) if t == 1 else
                   ((0, j, 2) if t == 2 else (i, 0, 3)))
        if t == 1:
            v = T1[i, j] - f(i, j)
            if v == T1[i - 1, j - 1]:
                pt = 1
            elif v == T2[i - 1, j - 1]:
                pt = 2
            else:
                pt = 3
            pi, pj = i - 1, j - 1
        elif t == 2:
            v = T2[i, j]
            if v == T1[i, j - 1] - g - h:
                pt = 1
            elif v == T2[i, j - 1] - g:
                pt = 2
            else:
                pt = 3
            pi, pj = i, j - 1
        else:
            v = T3[i, j]
            if v == T1[i - 1, j] - g - h:
                pt = 1
            elif v == T2[i - 1, j] - g - h:
                pt = 2
            else:
                pt = 3
            pi, pj = i - 1, j
        if pi == 0 or pj == 0:
            break
        if pt == 1 and T1[pi, pj] == 0.0:
            break
        i, j, t = pi, pj, pt
    return best, list(reversed(rev))
