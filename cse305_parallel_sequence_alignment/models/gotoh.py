"""Single-pair global affine-gap aligner (Gotoh), jit-compiled.

Device counterpart of the reference's ``Subproblem`` engine
(alignment_algorithm/subproblem_alignment.h:16-97): device-side row-scan
fill emitting a packed direction matrix, host-side reference-exact
traceback, reference-format output rows. Supports all start/end boundary
types of the partition protocol.
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
from cse305_parallel_sequence_alignment.ops.rowscan import (
    rowscan_dirs,
    rowscan_score,
    rowscan_tables,
)
from cse305_parallel_sequence_alignment.ops.traceback import (
    traceback_from_dirs,
)


def _as_enc(s):
    if isinstance(s, (str, bytes)):
        return encode_seq(s)
    return np.asarray(s, dtype=np.uint8)


@dataclasses.dataclass
class GotohAligner:
    """Global pairwise aligner with affine gaps.

    ``parity_swap`` mirrors the reference constructor's role swap for
    m > n (B8, subproblem_alignment.h:37-54) so outputs stay byte-equal;
    set False for conventional orientation-preserving behavior.
    """

    params: ScoringParams = ScoringParams()
    start_type: int = -1
    end_type: int = -1
    parity_swap: bool = True

    def _prep(self, a, b):
        a_enc, b_enc = _as_enc(a), _as_enc(b)
        swapped = False
        if self.parity_swap and a_enc.shape[0] > b_enc.shape[0]:
            a_enc, b_enc = b_enc, a_enc
            swapped = True
        return a_enc, b_enc, swapped

    def _kw(self):
        g, h, match, mismatch = self.params.astuple()
        return dict(g=g, h=h, match=match, mismatch=mismatch,
                    start_type=self.start_type)

    def score(self, a, b) -> float:
        """Boundary-adjusted optimal score (end-table choice applied)."""
        a_enc, b_enc, _ = self._prep(a, b)
        finals = np.asarray(
            rowscan_score(jnp.asarray(a_enc), jnp.asarray(b_enc),
                          **self._kw()))
        _, _, score = self._traceback_stub(finals)
        return score

    def _traceback_stub(self, finals):
        from cse305_parallel_sequence_alignment.core import (
            end_table_choice,
        )
        table, score = end_table_choice(
            float(finals[0]), float(finals[1]), float(finals[2]),
            self.end_type, self.params.h)
        return table, finals, score

    def tables(self, a, b):
        """Full T1/T2/T3 numpy tables (for tests and partition search)."""
        a_enc, b_enc, _ = self._prep(a, b)
        t1, t2, t3 = rowscan_tables(
            jnp.asarray(a_enc), jnp.asarray(b_enc), **self._kw())
        return np.asarray(t1), np.asarray(t2), np.asarray(t3)

    def align(self, a, b, id_a=0, id_b=0) -> AlignmentResult:
        """Full alignment: device fill + host traceback, reference parity."""
        a_enc, b_enc, _ = self._prep(a, b)
        m, n = a_enc.shape[0], b_enc.shape[0]
        dirs, finals = rowscan_dirs(
            jnp.asarray(a_enc), jnp.asarray(b_enc), **self._kw())
        chain, table, score = traceback_from_dirs(
            np.asarray(dirs), np.asarray(finals), m, n, self.params.h,
            self.end_type, id_a, id_b)
        row_a, row_b = format_alignment(
            bytes(a_enc), bytes(b_enc), chain)
        return AlignmentResult(score=score, chain=chain, aligned_a=row_a,
                               aligned_b=row_b, end_table=table)
