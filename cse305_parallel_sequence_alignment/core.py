"""Core types: scoring parameters, boundary semantics, codec, results.

The DP formulation follows Gotoh's three-matrix affine-gap recurrence as
specified by the reference engine (alignment_algorithm/subproblem_alignment.h
and .cpp):

- ``T1[i][j]``: best score of aligning A[1..i] vs B[1..j] ending in a
  match/mismatch column (consumes A[i] and B[j]).
- ``T2[i][j]``: ending in a gap in A (consumes B[j] only).
- ``T3[i][j]``: ending in a gap in B (consumes A[i] only).

with ``f(i,j) = match if A[i]==B[j] else mismatch`` (reference
subproblem_alignment.h:83-88 uses match=+1, mismatch=0) and a gap of length k
costing ``h + g*k`` (open ``h``, extend ``g``).

Scores are float32 with true ``-inf`` sentinels: the reference uses doubles
with ``-inf`` whose absorbing arithmetic (``-inf - g == -inf``) is
load-bearing for its traceback equality tests; float32 reproduces it exactly,
and all finite scores are small integers, exactly representable (<< 2**24).

Boundary *types* come from the partition layer: an alignment segment may be
required to start/end inside a specific table. Encoding (reference
subproblem_alignment.h:8-13 and main_alignment.cpp:250-251):

- ``t = 1``: diagonal (match/mismatch), ``2``: gap in A, ``3``: gap in B.
- negative start/end types mean "free choice anchored at table |t|":
  ``-1`` -> T1, ``-2`` -> T2, ``-3`` -> T3.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# float32 -inf: absorbing under +/- like the reference's double -inf.
NEG_INF = float("-inf")

# Direction codes inside a packed uint8: 2 bits per table.
# value 0 -> predecessor T1, 1 -> T2, 2 -> T3 (tie-break order of the
# reference traceback: first match among T1, T2, T3;
# subproblem_alignment.cpp:147-169).
DIR_T1_SHIFT = 0
DIR_T2_SHIFT = 2
DIR_T3_SHIFT = 4


@dataclasses.dataclass(frozen=True)
class ScoringParams:
    """Affine-gap scoring: similarity maximised, gaps cost ``h + g*k``.

    Defaults mirror the reference harness (test_functions/testing.cpp:134:
    ``g=1, h=2``; match/mismatch from subproblem_alignment.h:83-88).
    """

    g: float = 1.0  # gap extend
    h: float = 2.0  # gap open
    match: float = 1.0
    mismatch: float = 0.0

    def astuple(self):
        return (self.g, self.h, self.match, self.mismatch)


class LazyChain:
    """Sequence of ``(i, j, t)`` tuples materialised on first access.

    ``align_batch`` produces chains for every pair, but most consumers
    only read the rendered rows and score — building ~(m+n) Python
    tuples per pair dominated the measured end-to-end profile (46 ms of
    a 226 ms 128x2kb batch). The walk's compact (t, i, j) arrays are
    held instead and turned into the list on first touch; equality,
    iteration, indexing, and concatenation behave exactly like the
    eager list.
    """

    __slots__ = ("_tt", "_ii", "_jj", "_list")

    def __init__(self, tt, ii, jj):
        self._tt, self._ii, self._jj = tt, ii, jj
        self._list = None

    def _mat(self):
        if self._list is None:
            self._list = list(zip(self._ii.tolist(), self._jj.tolist(),
                                  self._tt.tolist()))
            self._tt = self._ii = self._jj = None
        return self._list

    def __len__(self):
        return (len(self._list) if self._list is not None
                else self._tt.shape[0])

    def __bool__(self):
        return len(self) > 0

    def __iter__(self):
        return iter(self._mat())

    def __getitem__(self, k):
        return self._mat()[k]

    def __eq__(self, other):
        if isinstance(other, LazyChain):
            other = other._mat()
        return self._mat() == other

    def __add__(self, other):
        return self._mat() + list(other)

    def __radd__(self, other):
        return list(other) + self._mat()

    def __repr__(self):
        return repr(self._mat())


@dataclasses.dataclass
class AlignmentResult:
    """Result of one pairwise alignment.

    ``chain`` is a list of ``(i, j, t)`` tuples in the reference's
    alignment_point convention (1-indexed; gap rows store 0 for the gapped
    side, quirk B2). ``aligned_a``/``aligned_b`` are the two text rows that
    the reference's ``print_seq`` emits (main_alignment.cpp:32-55).
    """

    score: float
    chain: list | None = None
    aligned_a: str | None = None
    aligned_b: str | None = None
    end_table: int | None = None

    def cigar(self) -> str:
        """SAM CIGAR of the chain (M/I/D; A is the query)."""
        from cse305_parallel_sequence_alignment.ops.cigar import (
            chain_to_cigar,
        )
        return chain_to_cigar(self.chain or [])


@dataclasses.dataclass(frozen=True)
class SubstitutionMatrix:
    """Full KxK substitution scoring over an explicit alphabet.

    Generalizes the reference's match/mismatch ``f()``
    (subproblem_alignment.h:83-88) to arbitrary per-pair scores (e.g.
    transition/transversion-aware DNA, IUPAC ambiguity). ``matrix`` is a
    row-major tuple of K*K floats (hashable, so params stay frozen).
    Code K (one past the alphabet) is the padding code; ``table()``
    appends a pad row/column of strongly-negative scores (never read by
    in-range cells, present so padded lanes stay well-defined).
    """

    alphabet: str
    matrix: tuple

    PAD_SCORE = -1e9

    def __post_init__(self):
        k = len(self.alphabet)
        if len(self.matrix) != k * k:
            raise ValueError(
                f"matrix needs {k * k} entries for alphabet "
                f"{self.alphabet!r}, got {len(self.matrix)}")

    @classmethod
    def from_array(cls, alphabet, arr):
        arr = np.asarray(arr, dtype=np.float32)
        return cls(alphabet=alphabet,
                   matrix=tuple(float(x) for x in arr.reshape(-1)))

    @classmethod
    def dna(cls, match=1.0, mismatch=0.0, alphabet="ACGTN"):
        k = len(alphabet)
        arr = np.full((k, k), mismatch, np.float32)
        np.fill_diagonal(arr, match)
        return cls.from_array(alphabet, arr)

    @property
    def k(self):
        return len(self.alphabet)

    @property
    def pad_code(self):
        return self.k

    def encode(self, s):
        """Sequence -> uint8 codes 0..K-1; unknown characters raise."""
        if isinstance(s, str):
            s = s.encode("ascii")
        lut = np.full(256, 255, np.uint8)
        for c, ch in enumerate(self.alphabet.encode("ascii")):
            lut[ch] = c
        codes = lut[np.frombuffer(bytes(s), np.uint8)]
        if np.any(codes == 255):
            bad = bytes(sorted(set(
                bytes(s)[i] for i in np.nonzero(codes == 255)[0])))
            raise ValueError(f"characters {bad!r} not in alphabet "
                             f"{self.alphabet!r}")
        return codes

    def table(self):
        """(K+1, K+1) float32 lookup with the pad row/column."""
        k = self.k
        t = np.full((k + 1, k + 1), self.PAD_SCORE, np.float32)
        t[:k, :k] = np.asarray(self.matrix,
                               np.float32).reshape(k, k)
        return t


def encode_seq(s, dtype=np.uint8):
    """ASCII string/bytes -> uint8 numpy array (0-indexed, no sentinel)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    return np.frombuffer(bytes(s), dtype=dtype).copy()


def decode_seq(arr):
    """uint8 numpy array -> ASCII string."""
    return bytes(np.asarray(arr, dtype=np.uint8)).decode("ascii")


def pad_to(arr, length, fill=0):
    """Pad a 1-D uint8 sequence array to ``length`` with ``fill``."""
    arr = np.asarray(arr)
    if arr.shape[0] >= length:
        return arr[:length]
    out = np.full((length,), fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def boundary_row0(n, start_type, g, h):
    """First-row boundary (i=0, j=0..n) for T1/T2/T3.

    Exactly the reference init, including its quirks (kept deliberately so
    subproblem boundary parity holds; see tests/golden):
    - corner (subproblem_alignment.cpp:261-272): all -inf, then
      T1=0 for start in {1,-1}, T2=0 for -2, T3=0 for -3
      (start in {2,3} leaves all three -inf).
    - j>=1 (subproblem_alignment.cpp:212-227): T1=T3=-inf;
      T2 = -g*j for start==-2; -inf for start in {1,3};
      else (-1, -3, and quirkily +2) -h-g*j.
    """
    t1 = np.full(n + 1, NEG_INF, np.float32)
    t2 = np.full(n + 1, NEG_INF, np.float32)
    t3 = np.full(n + 1, NEG_INF, np.float32)
    j = np.arange(1, n + 1, dtype=np.float32)
    if start_type in (1, -1):
        t1[0] = 0.0
    elif start_type == -2:
        t2[0] = 0.0
    elif start_type == -3:
        t3[0] = 0.0
    if start_type == -2:
        t2[1:] = -g * j
    elif start_type in (1, 3):
        pass  # stays -inf
    else:
        t2[1:] = -h - g * j
    return t1, t2, t3


def boundary_col0(m, start_type, g, h):
    """First-column boundary (j=0, i=1..m) values for T1/T2/T3.

    Reference subproblem_alignment.cpp:282-292: T1=T2=-inf;
    T3 = -g*i for start==-3; -inf for start in {1,2};
    else (-1, -2, and quirkily +3) -h-g*i. Returned arrays are length m
    (index 0 corresponds to row i=1).
    """
    t1 = np.full(m, NEG_INF, np.float32)
    t2 = np.full(m, NEG_INF, np.float32)
    t3 = np.full(m, NEG_INF, np.float32)
    i = np.arange(1, m + 1, dtype=np.float32)
    if start_type == -3:
        t3[:] = -g * i
    elif start_type in (1, 2):
        pass
    else:
        t3[:] = -h - g * i
    return t1, t2, t3


def end_table_choice(t1, t2, t3, end_type, h):
    """Pick the table the alignment ends in, reference semantics.

    For ``end_type > 0`` the table is forced. Otherwise argmax of
    (T1, T2 + h', T3 + h'') with the gap-open refund h' = h iff
    end_type == -2 (resp. -3), tie order T1 >= T2 >= T3
    (subproblem_alignment.cpp:112-146, h_prime at .h:91-96).
    Returns (table in {1,2,3}, adjusted best score).
    """
    if end_type > 0:
        return end_type, (t1, t2, t3)[end_type - 1]
    c1 = t1
    c2 = t2 + (h if end_type == -2 else 0.0)
    c3 = t3 + (h if end_type == -3 else 0.0)
    if c1 >= c2 and c1 >= c3:
        return 1, c1
    if c2 >= c1 and c2 >= c3:
        return 2, c2
    return 3, c3


def pack_dirs(d1, d2, d3):
    """Pack three 2-bit direction fields into one uint8 array."""
    return (
        (np.asarray(d1, np.uint8) << DIR_T1_SHIFT)
        | (np.asarray(d2, np.uint8) << DIR_T2_SHIFT)
        | (np.asarray(d3, np.uint8) << DIR_T3_SHIFT)
    )


def unpack_dirs(packed):
    """uint8 packed directions -> (d1, d2, d3) arrays of values in {0,1,2}."""
    packed = np.asarray(packed)
    return (
        (packed >> DIR_T1_SHIFT) & 0x3,
        (packed >> DIR_T2_SHIFT) & 0x3,
        (packed >> DIR_T3_SHIFT) & 0x3,
    )
