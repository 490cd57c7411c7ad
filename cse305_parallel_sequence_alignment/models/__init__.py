"""Aligner model families: oracle, global (Gotoh), local, semi-global, batch."""

from cse305_parallel_sequence_alignment.models.oracle import (
    oracle_align,
    oracle_tables,
)
from cse305_parallel_sequence_alignment.models.gotoh import GotohAligner
from cse305_parallel_sequence_alignment.models.batch import BatchAligner
from cse305_parallel_sequence_alignment.models.local import (
    LocalAlignmentResult,
    LocalBatchAligner,
)
from cse305_parallel_sequence_alignment.models.semiglobal import (
    SemiGlobalBatchAligner,
    SemiGlobalResult,
)
from cse305_parallel_sequence_alignment.models.banded import (
    BandedAligner,
)
from cse305_parallel_sequence_alignment.models.overlap import (
    OverlapBatchAligner,
    OverlapResult,
)

__all__ = [
    "BandedAligner",
    "OverlapBatchAligner",
    "OverlapResult",
    "SemiGlobalBatchAligner",
    "SemiGlobalResult",
    "oracle_align",
    "oracle_tables",
    "GotohAligner",
    "BatchAligner",
    "LocalBatchAligner",
    "LocalAlignmentResult",
]
