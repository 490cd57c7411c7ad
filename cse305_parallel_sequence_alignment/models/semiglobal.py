"""Bucketed batched semi-global aligner (A end-to-end, B free flanks).

Device fill: ops/semiglobal.py; host walk:
ops.traceback.traceback_semiglobal_from_dirs; CIGARs via ops/cigar.py.
Includes the serial numpy oracle used by the tests.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from cse305_parallel_sequence_alignment.core import (
    NEG_INF,
    ScoringParams,
    encode_seq,
)
from cse305_parallel_sequence_alignment.ops.cigar import (
    chain_to_cigar,
    chain_to_cigar_extended,
)
from cse305_parallel_sequence_alignment.ops import select
from cse305_parallel_sequence_alignment.ops.device_walk import (
    walk_semiglobal_batch_device,
)
from cse305_parallel_sequence_alignment.ops.semiglobal import (
    semiglobal_dirs_batch,
    semiglobal_score_batch,
)
from cse305_parallel_sequence_alignment.ops.traceback import (
    traceback_semiglobal_from_dirs,
)
from cse305_parallel_sequence_alignment.ops.wavefront import PAD_A, PAD_B


def sg_oracle_tables(a, b, params=ScoringParams()):
    """Serial semi-global tables: row 0 of T1 is free (zeros)."""
    a = encode_seq(a) if isinstance(a, (str, bytes)) else np.asarray(a)
    b = encode_seq(b) if isinstance(b, (str, bytes)) else np.asarray(b)
    m, n = len(a), len(b)
    g, h, match, mismatch = params.astuple()
    T1 = np.full((m + 1, n + 1), NEG_INF, np.float32)
    T2 = np.full((m + 1, n + 1), NEG_INF, np.float32)
    T3 = np.full((m + 1, n + 1), NEG_INF, np.float32)
    T1[0, :] = 0.0
    for i in range(1, m + 1):
        T3[i, 0] = -h - g * i
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            f = match if a[i - 1] == b[j - 1] else mismatch
            T1[i, j] = f + max(T1[i - 1, j - 1], T2[i - 1, j - 1],
                               T3[i - 1, j - 1])
            T3[i, j] = max(T1[i - 1, j] - g - h, T2[i - 1, j] - g - h,
                           T3[i - 1, j] - g)
            T2[i, j] = max(T1[i, j - 1] - g - h, T2[i, j - 1] - g,
                           T3[i, j - 1] - g - h)
    return T1, T2, T3


def sg_oracle_best(a, b, params=ScoringParams()):
    """(score, table, end_j): best over row m, T1 >= T2 >= T3 then
    smallest j (j >= 1)."""
    T1, T2, T3 = sg_oracle_tables(a, b, params)
    m = T1.shape[0] - 1
    best, bt, bj = float(NEG_INF), 1, 0
    for j in range(1, T1.shape[1]):
        for t, T in ((1, T1), (2, T2), (3, T3)):
            if T[m, j] > best:
                best, bt, bj = float(T[m, j]), t, j
    return best, bt, bj


@dataclasses.dataclass
class SemiGlobalResult:
    score: float
    chain: list
    cigar: str
    cigar_extended: str
    target_span: tuple  # (first, last) 1-based B columns aligned
    end_table: int


@dataclasses.dataclass
class SemiGlobalBatchAligner:
    """Aligns many (query, target) pairs semi-globally, length-bucketed."""

    params: ScoringParams = ScoringParams(g=1.0, h=2.0, match=1.0,
                                          mismatch=-1.0)
    bucket_quantum: int = 128
    max_batch: int = 512

    def _kw(self):
        g, h, match, mismatch = self.params.astuple()
        return dict(g=g, h=h, match=match, mismatch=mismatch)

    def _prep(self, pairs):
        enc_a = [encode_seq(p[0]) if isinstance(p[0], (str, bytes))
                 else np.asarray(p[0], np.uint8) for p in pairs]
        enc_b = [encode_seq(p[1]) if isinstance(p[1], (str, bytes))
                 else np.asarray(p[1], np.uint8) for p in pairs]
        buckets = {}

        def q(x):
            return max(self.bucket_quantum,
                       -(-x // self.bucket_quantum) * self.bucket_quantum)
        for k, (ea, eb) in enumerate(zip(enc_a, enc_b)):
            key = (q(ea.shape[0]), q(eb.shape[0]))
            buckets.setdefault(key, []).append(k)
        return enc_a, enc_b, buckets

    def _arrays(self, enc_a, enc_b, idxs, key):
        bm, bn = key
        B = len(idxs)
        a = np.full((B, bm), PAD_A, np.uint8)
        b = np.full((B, bn), PAD_B, np.uint8)
        la = np.zeros((B,), np.int32)
        lb = np.zeros((B,), np.int32)
        for r, k in enumerate(idxs):
            la[r], lb[r] = enc_a[k].shape[0], enc_b[k].shape[0]
            a[r, : la[r]] = enc_a[k]
            b[r, : lb[r]] = enc_b[k]
        return a, b, la, lb

    def score_batch(self, pairs):
        """(scores, end_tables, end_js) for all pairs."""
        enc_a, enc_b, buckets = self._prep(pairs)
        scores = np.zeros(len(pairs), np.float32)
        tables = np.zeros(len(pairs), np.int32)
        ejs = np.zeros(len(pairs), np.int32)
        for key, idxs in buckets.items():
            for s in range(0, len(idxs), self.max_batch):
                chunk = idxs[s: s + self.max_batch]
                a, b, la, lb = self._arrays(enc_a, enc_b, chunk, key)
                out = np.asarray(semiglobal_score_batch(
                    jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
                    jnp.asarray(lb), **self._kw()))
                scores[chunk] = out[:, 0]
                tables[chunk] = out[:, 1].astype(np.int32)
                ejs[chunk] = out[:, 3].astype(np.int32)
        return scores, tables, ejs

    def align_batch(self, pairs):
        enc_a, enc_b, buckets = self._prep(pairs)
        results: list = [None] * len(pairs)
        for key, idxs in buckets.items():
            for s in range(0, len(idxs), self.max_batch):
                chunk = idxs[s: s + self.max_batch]
                a, b, la, lb = self._arrays(enc_a, enc_b, chunk, key)
                out, dirs = semiglobal_dirs_batch(
                    jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
                    jnp.asarray(lb), **self._kw())
                out = np.asarray(out)
                if select.on_gpu():
                    # keep dirs on the device; the walk happens there
                    chains = walk_semiglobal_batch_device(
                        dirs, out[:, 1].astype(np.int64),
                        out[:, 2].astype(np.int64),
                        out[:, 3].astype(np.int64))
                else:
                    dirs = np.asarray(dirs)
                    chains = [traceback_semiglobal_from_dirs(
                        dirs[r], int(out[r, 1]), int(out[r, 2]),
                        int(out[r, 3]), layout="skew")
                        for r in range(len(chunk))]
                for r, k in enumerate(chunk):
                    t = int(out[r, 1])
                    ei, ej = int(out[r, 2]), int(out[r, 3])
                    chain = chains[r]
                    bcols = [j for (_, j, tt) in chain if tt in (1, 2)]
                    results[k] = SemiGlobalResult(
                        score=float(out[r, 0]), chain=chain,
                        cigar=chain_to_cigar(chain),
                        cigar_extended=chain_to_cigar_extended(
                            enc_a[k], enc_b[k], chain),
                        target_span=(bcols[0], bcols[-1]) if bcols
                        else (0, 0),
                        end_table=t)
        return results
