"""Unified convenience API over every alignment mode.

One call surface for users coming from the reference binary (which only
had ``main_alignment_function``):

    align(a, b)                          # global, reference semantics
    align(a, b, mode="local")            # SW + CIGAR
    align(a, b, mode="semiglobal")       # fit a into b
    align(a, b, mode="overlap")          # dovetail
    align(a, b, mode="banded", band=64)  # banded global
    align(a, b, mode="partitioned", p=8) # long-pair decomposition
    score_pairs(pairs, mode=...)         # batched scores
    align_pairs(pairs, mode=...)         # batched full alignments
"""

from __future__ import annotations

from cse305_parallel_sequence_alignment.core import ScoringParams

_MODES = ("global", "local", "semiglobal", "overlap", "banded",
          "partitioned")


def _params(params, mode, kw):
    if params is not None:
        return params
    if mode in ("local",):
        from cse305_parallel_sequence_alignment.models.local_oracle \
            import LOCAL_PARAMS
        return LOCAL_PARAMS
    if mode in ("semiglobal", "overlap"):
        return ScoringParams(g=1.0, h=2.0, match=1.0, mismatch=-1.0)
    return ScoringParams()


def _batch_aligner(mode, params, **kw):
    if mode == "global":
        from cse305_parallel_sequence_alignment.models.batch import (
            BatchAligner,
        )
        return BatchAligner(params=params, **kw)
    if mode == "local":
        from cse305_parallel_sequence_alignment.models.local import (
            LocalBatchAligner,
        )
        return LocalBatchAligner(params=params, **kw)
    if mode == "semiglobal":
        from cse305_parallel_sequence_alignment.models.semiglobal \
            import SemiGlobalBatchAligner
        return SemiGlobalBatchAligner(params=params, **kw)
    if mode == "overlap":
        from cse305_parallel_sequence_alignment.models.overlap import (
            OverlapBatchAligner,
        )
        return OverlapBatchAligner(params=params, **kw)
    raise ValueError(f"mode {mode!r} not batchable; use align()")


def align(a, b, mode="global", params=None, band=None, p=None, **kw):
    """One pairwise alignment in any mode; returns that mode's result
    object (AlignmentResult / LocalAlignmentResult / SemiGlobalResult /
    OverlapResult)."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}; pick from {_MODES}")
    params = _params(params, mode, kw)
    if mode == "banded":
        from cse305_parallel_sequence_alignment.models.banded import (
            BandedAligner,
        )
        w = band if band is not None else 64
        extra = abs(len(a) - len(b))
        return BandedAligner(params=params, w_lo=w + extra,
                             w_hi=w + extra, **kw).align(a, b)
    if mode == "partitioned":
        from cse305_parallel_sequence_alignment.parallel.partition \
            import PartitionedAligner
        return PartitionedAligner(params=params, p=p or 4,
                                  **kw).align(a, b)
    return _batch_aligner(mode, params, **kw).align_batch([(a, b)])[0]


def align_pairs(pairs, mode="global", params=None, **kw):
    """Batched full alignments (global/local/semiglobal/overlap)."""
    params = _params(params, mode, kw)
    return _batch_aligner(mode, params, **kw).align_batch(pairs)


def score_pairs(pairs, mode="global", params=None, **kw):
    """Batched scores only; returns the mode's score_batch tuple."""
    params = _params(params, mode, kw)
    return _batch_aligner(mode, params, **kw).score_batch(pairs)
