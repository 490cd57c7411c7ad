"""Native C++ host runtime (traceback walker, renderer, FASTA scanner).

Builds lazily via make on first import; all callers fall back to pure
Python/numpy if the toolchain or shared library is unavailable, so the
framework stays functional without a C++ compiler.
"""

from cse305_parallel_sequence_alignment.native import walker  # noqa: F401
