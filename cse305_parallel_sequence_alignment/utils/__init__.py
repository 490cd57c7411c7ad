"""IO and support utilities: FASTA, similarity, CSV schemas, config."""

from cse305_parallel_sequence_alignment.utils.fasta import (
    read_and_store_sequences,
)
from cse305_parallel_sequence_alignment.utils.similarity import (
    sequence_similarity,
)

__all__ = ["read_and_store_sequences", "sequence_similarity"]
