"""Traceback from packed direction matrices (host-side, sequential).

The DP fill stays on-device and emits 2-bit-per-table direction codes; the
inherently sequential walk happens on the host. The walk reproduces the
reference's traceback exactly (subproblem_alignment.cpp:105-172):

- end-table choice with gap-open refund and T1>=T2>=T3 tie order (B3),
- stop at the matrix edge and drop the first point (B1),
- gap points store 0 for the gapped side (B2).

Supports the rectangular layout (row-scan fill: dirs[i, j]) and the skewed
anti-diagonal layout (wavefront/Pallas fills: dirs[i + j, j]).

A native C++ walker (native/) accelerates batched traceback; this module
falls back to pure Python/numpy when the shared library is unavailable.
"""

from __future__ import annotations

import numpy as np

from cse305_parallel_sequence_alignment.core import (
    DIR_T1_SHIFT,
    DIR_T2_SHIFT,
    DIR_T3_SHIFT,
    end_table_choice,
)

_SHIFTS = {1: DIR_T1_SHIFT, 2: DIR_T2_SHIFT, 3: DIR_T3_SHIFT}


def traceback_from_dirs(dirs, finals, m, n, h, end_type=-1, id_a=0, id_b=0,
                        layout="rect", mode="parity"):
    """Walk a packed direction matrix back from (m, n).

    Args:
      dirs: uint8 array; ``rect`` layout (m+1, n+1), ``skew`` layout
        (m+n+1, n+1) where cell (i, j) lives at [i+j, j].
      finals: (3,) final-cell (T1, T2, T3) values at (m, n).
      m, n, h, end_type, id_a, id_b: reference conventions.
      mode: "parity" stops at the matrix edge like the reference (B1 —
        leading edge-gap columns are silently dropped); "full" continues
        the forced edge runs to (0, 0) so every alignment column is
        emitted (required for partitioned stitching, where a segment's
        path legitimately rides its left/top edge).

    Returns (chain, end_table, score); the first (deepest) point is
    dropped in both modes (in "full" mode it is exactly the (0,0)
    sentinel).
    """
    dirs = np.asarray(dirs)
    finals = np.asarray(finals, dtype=np.float64)
    table, score = end_table_choice(
        float(finals[0]), float(finals[1]), float(finals[2]), end_type, h)

    if isinstance(layout, tuple):  # ("band", w_lo): dirs[i, j - i + w_lo]
        w_lo = layout[1]

        def cell(i, j):
            return dirs[i, j - i + w_lo]
    elif layout == "skew":
        def cell(i, j):
            return dirs[i + j, j]
    else:
        def cell(i, j):
            return dirs[i, j]

    def point(pi, pj, t):
        if t == 1:
            return (pi + id_a, pj + id_b, 1)
        if t == 2:
            return (0, pj + id_b, 2)
        return (pi + id_a, 0, 3)

    rev = [point(m, n, table)]
    i, j, t = m, n, table
    native = _native_walk(dirs, m, n, t, layout)
    if native is not None:
        steps = native
        for (pt_t, pi, pj) in steps:
            rev.append(point(pi, pj, pt_t))
        if steps:
            # walk position after the native loop = last raw pred cell
            i, j = steps[-1][1], steps[-1][2]
    else:
        while i > 0 and j > 0:
            t_next = int((cell(i, j) >> _SHIFTS[t]) & 0x3) + 1
            if t == 1:
                pi, pj = i - 1, j - 1
                i, j = i - 1, j - 1
            elif t == 2:
                pi, pj = i, j - 1
                j = j - 1
            else:
                pi, pj = i - 1, j
                i = i - 1
            rev.append(point(pi, pj, t_next))
            t = t_next
    if mode == "full":
        # Forced edge runs: along row 0 only T2 (gap in A) is finite,
        # along column 0 only T3 (gap in B).
        if i == 0:
            while j > 0:
                rev.append(point(0, j - 1, 2))
                j -= 1
        else:
            while i > 0:
                rev.append(point(i - 1, 0, 3))
                i -= 1
    chain = list(reversed(rev))[1:]  # drop the first point (B1 / sentinel)
    return chain, table, score


def traceback_local_from_dirs(dirs, end_i, end_j, layout="skew"):
    """Local-mode walk: from the best T1 cell back to its local start.

    ``dirs`` comes from ops/local.py (T1 direction code 3 = the clamp won:
    the alignment starts at this cell). Returns the chain start..end; the
    end cell is (end_i, end_j, 1) by construction (best is over T1).
    No reference-parity quirks apply — the reference has no local mode —
    so the chain covers every aligned column.
    """
    dirs = np.asarray(dirs)

    def cell(i, j):
        return dirs[i + j, j] if layout == "skew" else dirs[i, j]

    rev = []
    i, j, t = int(end_i), int(end_j), 1
    while True:
        rev.append((i, j, t) if t == 1 else
                   ((0, j, 2) if t == 2 else (i, 0, 3)))
        code = int((cell(i, j) >> _SHIFTS[t]) & 0x3)
        if t == 1 and code == 3:
            # defensive: a clamped (value-0) cell is never aligned; it can
            # only be reached if the walk started on one
            rev.pop()
            break
        if t == 1:
            pi, pj, pt = i - 1, j - 1, code + 1
        elif t == 2:
            pi, pj, pt = i, j - 1, code + 1
        else:
            pi, pj, pt = i - 1, j, code + 1
        # the predecessor is the empty prefix when it sits on the zero
        # boundary or is a clamped T1 cell (code 3): stop before it
        if pi == 0 or pj == 0:
            break
        if pt == 1 and int((cell(pi, pj) >> _SHIFTS[1]) & 0x3) == 3:
            break
        i, j, t = pi, pj, pt
    return list(reversed(rev))


def traceback_semiglobal_from_dirs(dirs, end_t, end_i, end_j,
                                   layout="skew"):
    """Semi-global walk: from the best last-row cell back to row 0.

    The free B prefix ends the walk at i == 0 (its columns are not
    emitted); a path that reaches column 0 with i > 0 still owes the
    forced leading gap-in-B run, which IS emitted (those gaps are paid
    in this mode). Chain is start..end, every aligned column present.
    """
    dirs = np.asarray(dirs)

    def cell(i, j):
        return dirs[i + j, j] if layout == "skew" else dirs[i, j]

    rev = []
    i, j, t = int(end_i), int(end_j), int(end_t)
    while i > 0 and j > 0:
        rev.append((i, j, t) if t == 1 else
                   ((0, j, 2) if t == 2 else (i, 0, 3)))
        code = int((cell(i, j) >> _SHIFTS[t]) & 0x3)
        if t == 1:
            i, j = i - 1, j - 1
        elif t == 2:
            j = j - 1
        else:
            i = i - 1
        t = code + 1
    while i > 0:  # forced leading gap-in-B run along column 0
        rev.append((i, 0, 3))
        i -= 1
    return list(reversed(rev))


def traceback_overlap_from_dirs(dirs, end_t, end_i, end_j, layout="skew"):
    """Overlap-mode walk: from the best edge cell back to either zero
    boundary (both prefixes are free, so the walk simply stops there).
    Chain is start..end with every aligned column present."""
    dirs = np.asarray(dirs)

    def cell(i, j):
        return dirs[i + j, j] if layout == "skew" else dirs[i, j]

    rev = []
    i, j, t = int(end_i), int(end_j), int(end_t)
    while i > 0 and j > 0:
        rev.append((i, j, t) if t == 1 else
                   ((0, j, 2) if t == 2 else (i, 0, 3)))
        code = int((cell(i, j) >> _SHIFTS[t]) & 0x3)
        if t == 1:
            i, j = i - 1, j - 1
        elif t == 2:
            j = j - 1
        else:
            i = i - 1
        t = code + 1
    return list(reversed(rev))


def _native_walk(dirs, m, n, t, layout):
    """Use the C++ walker if built; returns list of (t', pi, pj) or None."""
    if not isinstance(layout, str):
        return None  # band layout: python walk only
    try:
        from cse305_parallel_sequence_alignment.native import walker
    except Exception:
        return None
    return walker.walk(dirs, m, n, t, layout)
