"""Batched pairwise sequence alignment on GPUs, in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
C++ course project ``D-2n/CSE305_Parallel_Sequence_Alignment`` (Gotoh
affine-gap global alignment, parallel-prefix row fill, balanced-partition
decomposition, FASTA ingestion, benchmark harness):

- ``core``      scoring config, boundary semantics, sequence codec, results
- ``ops``       compute kernels: row-scan fill, batched wavefront fill,
                the GPU fill kernel (Pallas/Triton), prefix scans,
                traceback, device walk
- ``models``    aligner families: global (Gotoh), local (Smith-Waterman),
                semi-global, batched/bucketed
- ``parallel``  device-mesh execution: many-pairs sharding, balanced
                partition, long-sequence pipeline with halo exchange
- ``utils``     FASTA I/O, similarity metric, CSV writers, config
- ``harness``   benchmark experiments mirroring the reference harness

Reference behavior citations use ``path:line`` within the reference
project's source tree.
"""

from cse305_parallel_sequence_alignment.utils.compile_cache import (
    enable_persistent_cache as _enable_persistent_cache,
)

_enable_persistent_cache()

from cse305_parallel_sequence_alignment.core import (  # noqa: E402
    NEG_INF,
    AlignmentResult,
    ScoringParams,
    SubstitutionMatrix,
    decode_seq,
    encode_seq,
)
from cse305_parallel_sequence_alignment.api import (
    align,
    align_pairs,
    score_pairs,
)

__version__ = "0.1.0"

__all__ = [
    "NEG_INF",
    "AlignmentResult",
    "ScoringParams",
    "SubstitutionMatrix",
    "encode_seq",
    "decode_seq",
    "align",
    "align_pairs",
    "score_pairs",
    "__version__",
]
