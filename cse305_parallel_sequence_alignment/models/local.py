"""Bucketed batched Smith-Waterman local aligner (affine gaps) + CIGARs.

Local-mode counterpart of models/batch.py: device wavefront fill
(ops/local.py), host traceback to the local start, CIGAR extraction
(ops/cigar.py). Covers BASELINE.json config 3 (batch SW with verified
traceback CIGARs). No reference-parity quirks apply: the reference
implements global alignment only.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from cse305_parallel_sequence_alignment.core import (
    ScoringParams,
    encode_seq,
)
from cse305_parallel_sequence_alignment.models.local_oracle import (
    LOCAL_PARAMS,
)
from cse305_parallel_sequence_alignment.ops.cigar import (
    chain_to_cigar,
    chain_to_cigar_extended,
)
from cse305_parallel_sequence_alignment.ops.local import (
    sw_dirs_batch,
    sw_score_batch,
)
from cse305_parallel_sequence_alignment.ops.traceback import (
    traceback_local_from_dirs,
)
from cse305_parallel_sequence_alignment.ops.wavefront import PAD_A, PAD_B


@dataclasses.dataclass
class LocalAlignmentResult:
    """One local alignment: score, end/start cells (1-based, inclusive),
    chain, CIGAR of the aligned segment."""

    score: float
    start_a: int
    start_b: int
    end_a: int
    end_b: int
    chain: list
    cigar: str
    cigar_extended: str


def _round_up(x, q):
    return max(q, -(-x // q) * q)


@dataclasses.dataclass
class LocalBatchAligner:
    """Aligns many pairs locally, length-bucketed like BatchAligner.

    Fill: the XLA wavefront (ops/local.py); walk: on the host.
    """

    params: ScoringParams = LOCAL_PARAMS
    bucket_quantum: int = 128
    max_batch: int = 512
    dirs_budget: int = 2 << 30  # align_batch chunk cap (bytes of dirs)

    def _kw(self):
        g, h, match, mismatch = self.params.astuple()
        return dict(g=g, h=h, match=match, mismatch=mismatch)

    def _best(self, a, b, la, lb):
        return np.asarray(sw_score_batch(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
            jnp.asarray(lb), **self._kw()))

    def _best_dirs(self, a, b, la, lb):
        """(best (B,3), skew dirs (B, m+n+1, n+1)) on the host."""
        best, dirs = sw_dirs_batch(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
            jnp.asarray(lb), **self._kw())
        return np.asarray(best), np.asarray(dirs)

    def _prep(self, pairs):
        enc_a = [encode_seq(p[0]) if isinstance(p[0], (str, bytes))
                 else np.asarray(p[0], np.uint8) for p in pairs]
        enc_b = [encode_seq(p[1]) if isinstance(p[1], (str, bytes))
                 else np.asarray(p[1], np.uint8) for p in pairs]
        buckets = {}
        for k, (ea, eb) in enumerate(zip(enc_a, enc_b)):
            key = (_round_up(ea.shape[0], self.bucket_quantum),
                   _round_up(eb.shape[0], self.bucket_quantum))
            buckets.setdefault(key, []).append(k)
        return enc_a, enc_b, buckets

    def _bucket_arrays(self, enc_a, enc_b, idxs, key):
        bm, bn = key
        B = len(idxs)
        a = np.full((B, bm), PAD_A, np.uint8)
        b = np.full((B, bn), PAD_B, np.uint8)
        la = np.zeros((B,), np.int32)
        lb = np.zeros((B,), np.int32)
        for r, k in enumerate(idxs):
            la[r] = enc_a[k].shape[0]
            lb[r] = enc_b[k].shape[0]
            a[r, : la[r]] = enc_a[k]
            b[r, : lb[r]] = enc_b[k]
        return a, b, la, lb

    def score_batch(self, pairs):
        """(scores, end_i, end_j) arrays for all pairs."""
        enc_a, enc_b, buckets = self._prep(pairs)
        scores = np.zeros(len(pairs), np.float32)
        ei = np.zeros(len(pairs), np.int32)
        ej = np.zeros(len(pairs), np.int32)
        for key, idxs in buckets.items():
            for s in range(0, len(idxs), self.max_batch):
                chunk = idxs[s: s + self.max_batch]
                a, b, la, lb = self._bucket_arrays(enc_a, enc_b, chunk, key)
                best = self._best(a, b, la, lb)
                scores[chunk] = best[:, 0]
                ei[chunk] = best[:, 1].astype(np.int32)
                ej[chunk] = best[:, 2].astype(np.int32)
        return scores, ei, ej

    def align_batch(self, pairs):
        """Full local alignments with CIGARs for all pairs."""
        enc_a, enc_b, buckets = self._prep(pairs)
        results: list = [None] * len(pairs)
        for key, idxs in buckets.items():
            bm, bn = key
            per_pair = (bm + bn + 1) * (bn + 1)
            step = max(1, min(self.max_batch,
                              self.dirs_budget // per_pair))
            for s in range(0, len(idxs), step):
                chunk = idxs[s: s + step]
                a, b, la, lb = self._bucket_arrays(enc_a, enc_b, chunk, key)
                best, dirs = self._best_dirs(a, b, la, lb)
                for r, k in enumerate(chunk):
                    score = float(best[r, 0])
                    if score <= 0.0:
                        results[k] = LocalAlignmentResult(
                            0.0, 0, 0, 0, 0, [], "", "")
                        continue
                    bi, bj = int(best[r, 1]), int(best[r, 2])
                    chain = traceback_local_from_dirs(
                        dirs[r], bi, bj, layout="skew")
                    sa = next(i for (i, _, t) in chain if t in (1, 3))
                    sb = next(j for (_, j, t) in chain if t in (1, 2))
                    results[k] = LocalAlignmentResult(
                        score=score, start_a=sa, start_b=sb,
                        end_a=bi, end_b=bj, chain=chain,
                        cigar=chain_to_cigar(chain),
                        cigar_extended=chain_to_cigar_extended(
                            enc_a[k], enc_b[k], chain))
        return results
