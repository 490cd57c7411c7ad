"""Banded global aligner: O(m*W) fill + band-coordinate traceback.

For pairs whose optimal path stays within the diagonal band (similar
sequences — the production fast path), with optional verification: when
the best path touches the band edge the result may be sub-optimal, so
``edge_safe`` reports whether the band bound is trustworthy.
"""

from __future__ import annotations

import dataclasses

from cse305_parallel_sequence_alignment.core import (
    AlignmentResult,
    ScoringParams,
    encode_seq,
)
from cse305_parallel_sequence_alignment.models.oracle import (
    format_alignment,
)
from cse305_parallel_sequence_alignment.ops.banded import (
    band_check,
    banded_dirs,
    banded_score,
)
from cse305_parallel_sequence_alignment.ops.traceback import (
    traceback_from_dirs,
)


@dataclasses.dataclass
class BandedAligner:
    """Global affine-gap aligner restricted to |i - j + (w_hi-w_lo)/..|
    band: j in [i - w_lo, i + w_hi].

    Exact whenever the optimal unrestricted path stays inside the band
    (guaranteed if w_lo/w_hi exceed the maximum gap run, e.g. both >=
    |m - n| + max_indels). ``align`` also reports ``edge_touched``: True
    when the traceback touched the band boundary, i.e. widening the band
    could improve the score.
    """

    params: ScoringParams = ScoringParams()
    w_lo: int = 64
    w_hi: int = 64
    start_type: int = -1
    end_type: int = -1
    traceback_mode: str = "parity"  # "full" emits forced edge runs

    def score(self, a, b):
        a_enc = encode_seq(a) if isinstance(a, (str, bytes)) else a
        b_enc = encode_seq(b) if isinstance(b, (str, bytes)) else b
        g, h, match, mismatch = self.params.astuple()
        finals = banded_score(a_enc, b_enc, self.w_lo, self.w_hi, g=g,
                              h=h, match=match, mismatch=mismatch,
                              start_type=self.start_type)
        from cse305_parallel_sequence_alignment.core import (
            end_table_choice,
        )
        _, s = end_table_choice(float(finals[0]), float(finals[1]),
                                float(finals[2]), self.end_type,
                                self.params.h)
        return s

    def align(self, a, b):
        a_enc = encode_seq(a) if isinstance(a, (str, bytes)) else a
        b_enc = encode_seq(b) if isinstance(b, (str, bytes)) else b
        m, n = len(a_enc), len(b_enc)
        band_check(m, n, self.w_lo, self.w_hi)
        g, h, match, mismatch = self.params.astuple()
        finals, dirs = banded_dirs(
            a_enc, b_enc, self.w_lo, self.w_hi, g=g, h=h, match=match,
            mismatch=mismatch, start_type=self.start_type)
        chain, table, score = traceback_from_dirs(
            dirs, finals, m, n, self.params.h, self.end_type,
            layout=("band", self.w_lo), mode=self.traceback_mode)
        row_a, row_b = format_alignment(bytes(a_enc), bytes(b_enc), chain)
        res = AlignmentResult(score=score, chain=chain, aligned_a=row_a,
                              aligned_b=row_b, end_table=table)
        res.edge_touched = any(
            (j - i) in (self.w_hi, -self.w_lo)
            for (i, j, t) in chain if t == 1)
        return res
