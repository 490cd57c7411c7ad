"""Serial numpy oracle: the parity Rosetta stone.

A transparent, loop-free-but-slow implementation of the Gotoh three-matrix
fill and the reference's exact traceback semantics. Every faster path (row
scan, wavefront, Pallas kernels, sharded pipelines) is tested against this
oracle, and this oracle is tested against golden outputs captured from the
repaired reference binary (tests/golden/cases.jsonl).

Reference behavior reproduced here (see SURVEY.md §4.2):
- B1: the first traceback point is dropped and the walk stops at the matrix
  edge (subproblem_alignment.cpp:147,170) -> leading edge gaps not emitted.
- B2: gap points store 0 for the gapped side's index.
- B3: tie-break order T1 >= T2 >= T3 everywhere.
- B8: if m > n the whole problem is transposed up front (the reference
  constructor swaps and never un-swaps; subproblem_alignment.h:37-54).
- B5 is NOT reproduced: the reference writes ``j-1 + id_A`` (wrong offset)
  in one traceback branch; we use offsets correctly. Identical whenever
  id_A == id_B == 0, which is the only configuration the reference can
  actually print (single subproblem).
"""

from __future__ import annotations

import numpy as np

from cse305_parallel_sequence_alignment.core import (
    NEG_INF,
    AlignmentResult,
    ScoringParams,
    boundary_col0,
    boundary_row0,
    encode_seq,
    end_table_choice,
)


def oracle_tables(a, b, params=ScoringParams(), start_type=-1,
                  matrix=None):
    """Full (m+1, n+1) float32 T1/T2/T3 tables, serial fill.

    Matches reference ``non_parallel_tables``
    (subproblem_alignment.cpp:357-399) and the parallel fill it validates.
    ``matrix`` (core.SubstitutionMatrix) replaces the match/mismatch rule
    with a full per-pair lookup.
    """
    a = encode_seq(a) if isinstance(a, (str, bytes)) else np.asarray(a)
    b = encode_seq(b) if isinstance(b, (str, bytes)) else np.asarray(b)
    m, n = len(a), len(b)
    g, h, match, mismatch = params.astuple()
    if matrix is not None:
        tbl = matrix.table()
        ca, cb = matrix.encode(bytes(a)), matrix.encode(bytes(b))

    T1 = np.full((m + 1, n + 1), NEG_INF, np.float32)
    T2 = np.full((m + 1, n + 1), NEG_INF, np.float32)
    T3 = np.full((m + 1, n + 1), NEG_INF, np.float32)
    r1, r2, r3 = boundary_row0(n, start_type, g, h)
    T1[0], T2[0], T3[0] = r1, r2, r3
    c1, c2, c3 = boundary_col0(m, start_type, g, h)
    T1[1:, 0], T2[1:, 0], T3[1:, 0] = c1, c2, c3

    for i in range(1, m + 1):
        for j in range(1, n + 1):
            if matrix is not None:
                f = float(tbl[ca[i - 1], cb[j - 1]])
            else:
                f = match if a[i - 1] == b[j - 1] else mismatch
            T1[i, j] = f + max(T1[i - 1, j - 1], T2[i - 1, j - 1],
                               T3[i - 1, j - 1])
            T3[i, j] = max(T1[i - 1, j] - g - h, T2[i - 1, j] - g - h,
                           T3[i - 1, j] - g)
            T2[i, j] = max(T1[i, j - 1] - g - h, T2[i, j - 1] - g,
                           T3[i, j - 1] - g - h)
    return T1, T2, T3


def oracle_traceback(a, b, T1, T2, T3, params=ScoringParams(), end_type=-1,
                     id_a=0, id_b=0):
    """Reference-exact traceback from full tables.

    Returns (chain, end_table, score): ``chain`` is the list of (i, j, t)
    points the reference's print path sees, i.e. *after* dropping the first
    point (B1); ``score`` is the boundary-adjusted end-cell value.
    """
    a = encode_seq(a) if isinstance(a, (str, bytes)) else np.asarray(a)
    b = encode_seq(b) if isinstance(b, (str, bytes)) else np.asarray(b)
    m, n = len(a), len(b)
    g, h, match, mismatch = params.astuple()

    def f(i, j):
        return match if a[i - 1] == b[j - 1] else mismatch

    table, score = end_table_choice(
        float(T1[m, n]), float(T2[m, n]), float(T3[m, n]), end_type, h)
    if table == 1:
        end_pt = (m + id_a, n + id_b, 1)
    elif table == 2:
        end_pt = (0, n + id_b, 2)
    else:
        end_pt = (m + id_a, 0, 3)

    rev = [end_pt]
    i, j, t = m, n, table
    while i > 0 and j > 0:
        if t == 1:
            v = T1[i, j]
            if v == f(i, j) + T1[i - 1, j - 1]:
                pt = (i - 1 + id_a, j - 1 + id_b, 1)
                t = 1
            elif v == f(i, j) + T2[i - 1, j - 1]:
                pt = (0, j - 1 + id_b, 2)
                t = 2
            else:
                pt = (i - 1 + id_a, 0, 3)
                t = 3
            i, j = i - 1, j - 1
        elif t == 2:
            v = T2[i, j]
            if v == -g - h + T1[i, j - 1]:
                pt = (i + id_a, j - 1 + id_b, 1)
                t = 1
            elif v == -g + T2[i, j - 1]:
                pt = (0, j - 1 + id_b, 2)
                t = 2
            else:
                pt = (i + id_a, 0, 3)
                t = 3
            j = j - 1
        else:
            v = T3[i, j]
            if v == -g - h + T1[i - 1, j]:
                pt = (i - 1 + id_a, j + id_b, 1)
                t = 1
            elif v == -g - h + T2[i - 1, j]:
                pt = (0, j + id_b, 2)
                t = 2
            else:
                pt = (i - 1 + id_a, 0, 3)
                t = 3
            i = i - 1
        rev.append(pt)
    # rev is end..start; the reference's chain is start..end with the very
    # first (deepest) point dropped (B1: alignment_begin = curr->next).
    chain = list(reversed(rev))[1:]
    return chain, table, score


def format_alignment(a, b, chain):
    """The two text rows of the reference's print_seq
    (main_alignment.cpp:32-55), using 1-indexed source positions."""
    a = "-" + (a if isinstance(a, str) else a.decode("ascii"))
    b = "-" + (b if isinstance(b, str) else b.decode("ascii"))
    row_a = "".join(a[i] if t in (1, 3) else "-" for (i, j, t) in chain)
    row_b = "".join(b[j] if t in (1, 2) else "-" for (i, j, t) in chain)
    return row_a, row_b


def oracle_align(a, b, params=ScoringParams(), start_type=-1, end_type=-1,
                 parity_swap=True):
    """Full single-subproblem alignment with reference-parity semantics.

    ``parity_swap`` reproduces the constructor's role swap for m > n (B8);
    the returned aligned rows then refer to the swapped roles, exactly like
    the reference's internal state.
    """
    a_str = a if isinstance(a, str) else bytes(a).decode("ascii")
    b_str = b if isinstance(b, str) else bytes(b).decode("ascii")
    if parity_swap and len(a_str) > len(b_str):
        a_str, b_str = b_str, a_str
    T1, T2, T3 = oracle_tables(a_str, b_str, params, start_type)
    chain, table, score = oracle_traceback(
        a_str, b_str, T1, T2, T3, params, end_type)
    row_a, row_b = format_alignment(a_str, b_str, chain)
    return AlignmentResult(score=score, chain=chain, aligned_a=row_a,
                           aligned_b=row_b, end_table=table)
