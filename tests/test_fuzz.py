"""Differential fuzzing: all fill engines against the serial oracle.

Randomized sweeps over lengths, scoring parameters, and boundary types;
every engine (rowscan, wavefront, the GPU kernel in interpret mode,
longseq) must agree
with the numpy oracle cell-for-cell at the final boundary, and the
traceback chains must re-score to the reported value.
"""

import jax.numpy as jnp
import numpy as np

from cse305_parallel_sequence_alignment.core import ScoringParams
from cse305_parallel_sequence_alignment.models.batch import BatchAligner
from cse305_parallel_sequence_alignment.models.oracle import (
    oracle_align,
    oracle_tables,
)
from cse305_parallel_sequence_alignment.ops.gpu_fill import gpu_fill
from cse305_parallel_sequence_alignment.ops.rowscan import rowscan_score
from cse305_parallel_sequence_alignment.ops.wavefront import (
    PAD_A,
    PAD_B,
    wavefront_score_batch,
)
from cse305_parallel_sequence_alignment.parallel.partition import (
    score_chain,
)

N_CASES = 12


def _case(rng):
    m = int(rng.integers(1, 48))
    n = int(rng.integers(1, 48))
    g = float(rng.integers(1, 4))
    h = float(rng.integers(0, 5))
    match = float(rng.integers(1, 3))
    mismatch = float(rng.integers(-2, 1))
    st = int(rng.choice([-1, -2, -3, 1, 2, 3]))
    a = "".join(rng.choice(list("ACGT"), m))
    b = "".join(rng.choice(list("ACGT"), n))
    return a, b, ScoringParams(g, h, match, mismatch), st


def test_fuzz_engines_agree_with_oracle():
    rng = np.random.default_rng(2026)
    for _ in range(N_CASES):
        a, b, params, st = _case(rng)
        g, h, match, mismatch = params.astuple()
        T1, T2, T3 = oracle_tables(a, b, params, start_type=st)
        want = np.array([T1[-1, -1], T2[-1, -1], T3[-1, -1]], np.float32)

        got_rs = np.asarray(rowscan_score(
            jnp.asarray(np.frombuffer(a.encode(), np.uint8)),
            jnp.asarray(np.frombuffer(b.encode(), np.uint8)),
            g=g, h=h, match=match, mismatch=mismatch, start_type=st))
        np.testing.assert_array_equal(got_rs, want, err_msg=f"rowscan {a} {b}")

        ea = np.frombuffer(a.encode(), np.uint8)[None]
        eb = np.frombuffer(b.encode(), np.uint8)[None]
        la = np.array([len(a)], np.int32)
        lb = np.array([len(b)], np.int32)
        got_wf = np.asarray(wavefront_score_batch(
            jnp.asarray(ea), jnp.asarray(eb), jnp.asarray(la),
            jnp.asarray(lb), g=g, h=h, match=match, mismatch=mismatch,
            start_type=st))[0]
        np.testing.assert_array_equal(got_wf, want,
                                      err_msg=f"wavefront {a} {b}")


def test_fuzz_pallas_interpret_matches_wavefront():
    rng = np.random.default_rng(2027)
    for _ in range(4):  # interpret mode is slower; fewer cases
        a, b, params, st = _case(rng)
        g, h, match, mismatch = params.astuple()
        bm, bn = len(a), len(b)
        ea = np.full((8, bm), PAD_A, np.uint8)
        eb = np.full((8, bn), PAD_B, np.uint8)
        ea[0, : len(a)] = np.frombuffer(a.encode(), np.uint8)
        eb[0, : len(b)] = np.frombuffer(b.encode(), np.uint8)
        la = np.full(8, len(a), np.int32)
        lb = np.full(8, len(b), np.int32)
        got = np.asarray(gpu_fill(
            jnp.asarray(ea), jnp.asarray(eb), jnp.asarray(la),
            jnp.asarray(lb), jnp.full((8,), st, jnp.int32), g=g, h=h,
            match=match, mismatch=mismatch, want_dirs=False, block=8,
            strip=4, S=2, C=8, interpret=True)[0])[0]
        T1, T2, T3 = oracle_tables(a, b, params, start_type=st)
        want = np.array([T1[-1, -1], T2[-1, -1], T3[-1, -1]], np.float32)
        np.testing.assert_array_equal(got, want, err_msg=f"{a} {b}")


def test_fuzz_chains_rescore_exactly():
    rng = np.random.default_rng(2028)
    for _ in range(N_CASES):
        a, b, params, _ = _case(rng)
        aligner = BatchAligner(params=params, parity_swap=False)
        res = aligner.align_batch([(a, b)], offsets=[(0, 0)],
                                  traceback_mode="full")[0]
        ea = np.frombuffer(a.encode(), np.uint8)
        eb = np.frombuffer(b.encode(), np.uint8)
        # full-mode chains cover the whole grid: re-scoring is exact
        assert score_chain(ea, eb, res.chain, params) == res.score, (a, b)


def test_fuzz_default_params_byte_parity_paths():
    """Default (reference) params: wavefront+batch output must equal the
    oracle's parity semantics including aligned rows."""
    rng = np.random.default_rng(2029)
    for _ in range(N_CASES):
        m = int(rng.integers(1, 60))
        n = int(rng.integers(1, 60))
        a = "".join(rng.choice(list("ACGT"), m))
        b = "".join(rng.choice(list("ACGT"), n))
        res = BatchAligner().align_batch([(a, b)])[0]
        want = oracle_align(a, b)
        assert res.aligned_a == want.aligned_a, (a, b)
        assert res.aligned_b == want.aligned_b, (a, b)
        assert res.score == want.score


def test_fuzz_fused_rle_path_vs_wavefront():
    """Randomized end-to-end sweep of the fused path (GPU kernel dirs
    words + RLE device walk + native replay) against the
    XLA wavefront + host walk: chains, scores, and rendered rows must
    be identical under random scoring params and boundary types."""
    rng = np.random.default_rng(77)
    for _ in range(6):
        a, b, params, st = _case(rng)
        en = int(rng.choice([-1, -2, -3, 1, 2, 3]))
        pairs = [(a, b)]
        for _ in range(int(rng.integers(1, 4))):
            m2 = int(rng.integers(1, 60))
            n2 = int(rng.integers(1, 60))
            pairs.append(("".join(rng.choice(list("ACGT"), m2)),
                          "".join(rng.choice(list("ACGT"), n2))))
        kw = dict(params=params, start_type=st, end_type=en)
        got = BatchAligner(backend="kernel", **kw).align_batch(pairs)
        want = BatchAligner(backend="wavefront", **kw).align_batch(pairs)
        for g_, w_ in zip(got, want):
            assert g_.score == w_.score, (st, en)
            assert g_.chain == w_.chain, (st, en)
            assert g_.aligned_a == w_.aligned_a
            assert g_.aligned_b == w_.aligned_b
