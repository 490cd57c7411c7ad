"""Balanced-partition decomposition — the reference's intended P5, corrected.

The reference's partition engine (sequence_alignment/partial.cpp:81-163) is
disabled at HEAD because of inverted scoring polarity, inconsistent
boundaries, and band-vs-line scans (SURVEY.md §3.2/B10). This module
implements the *intended* algorithm — crossing points of an optimal path
found from forward + reverse DP — but hierarchically (Myers/Miller-style
bisection), which guarantees all crossing points lie on one optimal path
(the reference's independent per-band argmaxes do not):

  1. fill forward to the middle row, capture that row of T1/T2/T3;
  2. fill the reverse problem (reversed sequences) to the same row;
  3. the optimal path crosses the row at argmax_j,t of
         T1+TR1,  T2+TR2+h,  T3+TR3+h
     (gap-open refund h when a gap is split — partial.cpp:101-105 had the
     same refund);
  4. recurse into the two sub-rectangles until p segments exist.

Total fill work is <= 4·m·n cells regardless of p; every segment is then an
independent Subproblem-style solve with anchored boundary types, exactly the
structure the reference's optimal_alignment consumes (main_alignment.cpp:
202-341) — but stitched without its B6/B7 truncation bugs.

This is also the long-sequence traceback enabler: each segment's direction
matrix is O(m·n/p), the reference's stated reason for the layer.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from cse305_parallel_sequence_alignment.core import (
    AlignmentResult,
    ScoringParams,
    encode_seq,
)
from cse305_parallel_sequence_alignment.models.oracle import (
    format_alignment,
)
from cse305_parallel_sequence_alignment.models.batch import BatchAligner
from cse305_parallel_sequence_alignment.ops.rowscan import (
    rowscan_lastrow,
)


def _mirror_type(t):
    """Boundary type as seen by the reversed problem (roles of A/B are
    preserved under joint reversal, so types map to themselves)."""
    return t


def _lastrow_rowscan(a_enc, b_enc, params, start_type):
    g, h, match, mismatch = params.astuple()
    return np.asarray(rowscan_lastrow(
        jnp.asarray(a_enc), jnp.asarray(b_enc), g=g, h=h, match=match,
        mismatch=mismatch, start_type=start_type))


def crossing_on_row(a_enc, b_enc, i_mid, params, start_type, end_type,
                    lastrow_fn=_lastrow_rowscan):
    """Best crossing cell (j, t) on row ``i_mid`` of an optimal path.

    ``lastrow_fn(a, b, params, start_type) -> (3, n+1)`` computes the
    forward/reverse row values — single-device rowscan by default, or the
    column-sharded pipeline (parallel.longseq.longseq_lastrow) for grids
    too large for one chip. Returns (j, t, total_score)."""
    g, h, _, _ = params.astuple()
    fwd = lastrow_fn(a_enc[:i_mid], b_enc, params, start_type)
    rev = lastrow_fn(a_enc[i_mid:][::-1], b_enc[::-1], params,
                     _mirror_type(end_type))
    n = b_enc.shape[0]
    # rev row is indexed by reversed j: TR[i_mid][j] = rev[:, n - j]
    rev_al = rev[:, ::-1]  # now indexed by j
    tot1 = fwd[0] + rev_al[0]
    tot2 = fwd[1] + rev_al[1] + h
    tot3 = fwd[2] + rev_al[2] + h
    stacked = np.stack([tot1, tot2, tot3])  # (3, n+1)
    best = np.max(stacked)
    # deterministic tie-break: smallest j, then table order T1, T2, T3
    cand_t, cand_j = np.nonzero(stacked == best)
    order = np.lexsort((cand_t, cand_j))
    j = int(cand_j[order[0]])
    t = int(cand_t[order[0]]) + 1
    return j, t, float(best)


def balanced_partition(a, b, p, params=ScoringParams(), start_type=-1,
                       end_type=-1, lastrow_fn=_lastrow_rowscan):
    """p+1 crossing points [(i, j, t)] splitting the DP grid into p
    row-balanced segments; interior points carry positive table types.

    The first point is (0, 0, start_type) and the last (m, n, -end_type)
    so segments consume them as the reference's optimal_alignment does
    (start = point.t, end = -next_point.t; main_alignment.cpp:250-251).

    The bisection runs level by level: all crossings at one depth are
    independent of each other.
    """
    a_enc = encode_seq(a) if isinstance(a, (str, bytes)) else np.asarray(a)
    b_enc = encode_seq(b) if isinstance(b, (str, bytes)) else np.asarray(b)
    m, n = a_enc.shape[0], b_enc.shape[0]

    points = {0: (0, 0, start_type), p: (m, n, -end_type)}
    frontier = [(0, p)]
    while frontier:
        tasks, keys, nxt = [], [], []
        for (k_lo, k_hi) in frontier:
            if k_hi - k_lo < 2:
                continue
            k_mid = (k_lo + k_hi) // 2
            i_lo, j_lo, t_lo = points[k_lo]
            i_hi, j_hi, t_hi = points[k_hi]
            # target global row for this split: proportional in index
            i_mid = i_lo + (i_hi - i_lo) * (k_mid - k_lo) // (k_hi - k_lo)
            sub_a = a_enc[i_lo:i_hi]
            sub_b = b_enc[j_lo:j_hi]
            st = t_lo if k_lo > 0 else start_type
            en = (-t_hi) if k_hi < p else end_type
            if sub_a.shape[0] == 0:
                # zero rows: pure gap-in-A run; any j split works
                points[k_mid] = (i_lo, (j_lo + j_hi) // 2, 2)
            elif sub_b.shape[0] == 0:
                # zero columns: pure gap-in-B run; split the row range
                points[k_mid] = (i_mid, j_lo, 3)
            else:
                tasks.append((sub_a, sub_b, i_mid - i_lo, st, en))
                keys.append((k_mid, i_mid, j_lo))
            nxt.append((k_lo, k_mid))
            nxt.append((k_mid, k_hi))
        if tasks:
            results = [
                crossing_on_row(sa, sb, im, params, st, en,
                                lastrow_fn=lastrow_fn)
                for (sa, sb, im, st, en) in tasks]
            for (k_mid, i_mid, j_lo), (j_rel, t, _) in zip(keys, results):
                points[k_mid] = (i_mid, j_lo + j_rel, t)
        frontier = nxt
    return [points[k] for k in range(p + 1)]


@dataclasses.dataclass
class PartitionedAligner:
    """Global aligner with balanced-partition decomposition.

    Finds p crossing points, solves the p segments as independent
    anchored subproblems (batched on device), stitches the chains —
    the corrected end-to-end version of the reference's
    main_alignment_function with the partition layer enabled
    (main_alignment.cpp:353-410 + partial.cpp).
    """

    params: ScoringParams = ScoringParams()
    p: int = 4  # 0 = auto: pick from mem_budget (O(m*n/p) per segment)
    parity_swap: bool = True
    # coarse buckets: segment shapes vary run to run, and each distinct
    # padded shape is a fresh kernel compile
    bucket_quantum: int = 512
    backend: str = "auto"
    # per-segment direction-matrix budget (bytes) used when p == 0
    mem_budget: int = 1 << 30
    # crossing-point search fill: "rowscan" (single-device XLA row
    # scan) or "sharded" (column-sharded longseq pipeline over the
    # devices of ``mesh``)
    fill_backend: str = "rowscan"
    mesh: object = None

    def _lastrow_fn(self):
        if self.fill_backend == "sharded":
            from cse305_parallel_sequence_alignment.parallel.longseq \
                import longseq_lastrow

            def fn(a_enc, b_enc, params, start_type):
                return longseq_lastrow(a_enc, b_enc, params,
                                       start_type=start_type,
                                       mesh=self.mesh)
            return fn
        if self.fill_backend != "rowscan":
            raise ValueError(f"fill_backend must be 'rowscan' or "
                             f"'sharded', got {self.fill_backend!r}")
        return _lastrow_rowscan

    def _pick_p(self, m, n):
        """Segment count: explicit, or smallest p whose per-segment
        traceback matrix (skew layout, ~(m/p + n/p) * (n/p) bytes) fits
        the budget."""
        if self.p > 0:
            return self.p
        p = 1
        while p < 4096:
            seg_m, seg_n = -(-m // p), -(-n // p)
            if (seg_m + seg_n + 1) * (seg_n + 1) <= self.mem_budget:
                return max(p, 1)
            p *= 2
        return p

    def partition(self, a, b):
        a_enc = encode_seq(a) if isinstance(a, (str, bytes)) else a
        b_enc = encode_seq(b) if isinstance(b, (str, bytes)) else b
        if self.parity_swap and len(a_enc) > len(b_enc):
            a_enc, b_enc = b_enc, a_enc
        return balanced_partition(
            a_enc, b_enc, self._pick_p(len(a_enc), len(b_enc)),
            self.params, lastrow_fn=self._lastrow_fn())

    def align(self, a, b) -> AlignmentResult:
        a_enc = encode_seq(a) if isinstance(a, (str, bytes)) else \
            np.asarray(a, np.uint8)
        b_enc = encode_seq(b) if isinstance(b, (str, bytes)) else \
            np.asarray(b, np.uint8)
        if self.parity_swap and a_enc.shape[0] > b_enc.shape[0]:
            a_enc, b_enc = b_enc, a_enc
        points = balanced_partition(
            a_enc, b_enc, self._pick_p(a_enc.shape[0], b_enc.shape[0]),
            self.params, lastrow_fn=self._lastrow_fn())

        # Solve all segments as one bucketed batch per (start, end) type.
        segments = []
        for k in range(len(points) - 1):
            (i0, j0, t0), (i1, j1, t1) = points[k], points[k + 1]
            st = t0 if k > 0 else -1
            en = -t1 if k < len(points) - 2 else -1
            segments.append((k, i0, j0, a_enc[i0:i1], b_enc[j0:j1], st, en))

        chains = {}
        aligner = BatchAligner(
            params=self.params, parity_swap=False,
            bucket_quantum=self.bucket_quantum, backend=self.backend)
        if aligner._use_kernel():
            # one mixed-type batch: the fused kernel takes per-pair
            # boundary types, so every segment ships in a single
            # bucketed dispatch stream regardless of anchor types
            results = aligner.align_batch(
                [(s[3], s[4]) for s in segments],
                offsets=[(s[1], s[2]) for s in segments],
                traceback_mode="full",
                start_types=[s[5] for s in segments],
                end_types=[s[6] for s in segments])
            for seg, res in zip(segments, results):
                chains[seg[0]] = res
        else:
            by_type = {}
            for seg in segments:
                by_type.setdefault((seg[5], seg[6]), []).append(seg)
            for (st, en), segs in by_type.items():
                aligner = BatchAligner(
                    params=self.params, start_type=st, end_type=en,
                    parity_swap=False, bucket_quantum=self.bucket_quantum,
                    backend=self.backend)
                results = aligner.align_batch(
                    [(s[3], s[4]) for s in segs],
                    offsets=[(s[1], s[2]) for s in segs],
                    traceback_mode="full")
                for seg, res in zip(segs, results):
                    chains[seg[0]] = res
        full_chain = []
        for k in range(len(segments)):
            full_chain.extend(chains[k].chain)
        # score: evaluate the stitched alignment (exact, no refund algebra)
        score = score_chain(a_enc, b_enc, full_chain, self.params)
        row_a, row_b = format_alignment(bytes(a_enc), bytes(b_enc),
                                        full_chain)
        return AlignmentResult(score=score, chain=full_chain,
                               aligned_a=row_a, aligned_b=row_b,
                               end_table=chains[len(segments) - 1].end_table)


def score_chain(a_enc, b_enc, chain, params=ScoringParams()):
    """Score an explicit alignment chain under the affine model (the
    independent evaluator used to validate stitched alignments)."""
    g, h, match, mismatch = params.astuple()
    score = 0.0
    prev_t = None
    for (i, j, t) in chain:
        if t == 1:
            score += match if a_enc[i - 1] == b_enc[j - 1] else mismatch
        else:
            score -= g
            if t != prev_t:
                score -= h
        prev_t = t
    return score
