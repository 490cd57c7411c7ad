"""Compute kernels: prefix scans, DP fills (row-scan, wavefront, the GPU
fill kernel), traceback and the device walk."""

from cse305_parallel_sequence_alignment.ops.prefix import (
    prefix_max,
    prefix_sum,
)
from cse305_parallel_sequence_alignment.ops.rowscan import (
    rowscan_dirs,
    rowscan_score,
    rowscan_tables,
)
from cse305_parallel_sequence_alignment.ops.traceback import (
    traceback_from_dirs,
    traceback_local_from_dirs,
)
from cse305_parallel_sequence_alignment.ops.cigar import (
    chain_to_cigar,
    chain_to_cigar_extended,
    cigar_consumed,
)
from cse305_parallel_sequence_alignment.ops.local import (
    sw_dirs_batch,
    sw_score_batch,
)

__all__ = [
    "prefix_max",
    "prefix_sum",
    "rowscan_tables",
    "rowscan_dirs",
    "rowscan_score",
    "traceback_from_dirs",
    "traceback_local_from_dirs",
    "chain_to_cigar",
    "chain_to_cigar_extended",
    "cigar_consumed",
    "sw_score_batch",
    "sw_dirs_batch",
]
