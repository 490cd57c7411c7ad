"""Native C++ host runtime vs pure-Python fallbacks."""

import numpy as np
import pytest

from cse305_parallel_sequence_alignment.native import walker
from cse305_parallel_sequence_alignment.models.gotoh import GotohAligner
from cse305_parallel_sequence_alignment.models.oracle import oracle_align

pytestmark = pytest.mark.skipif(
    not walker.available(), reason="native library not built")


def test_native_walk_equals_python():
    # GotohAligner.align uses the native walker when available; compare
    # against the oracle's pure-python equality retrace.
    rng = np.random.default_rng(21)
    for (m, n) in [(10, 10), (37, 53), (64, 64)]:
        a = "".join(rng.choice(list("ACGT"), m))
        b = "".join(rng.choice(list("ACGT"), n))
        got = GotohAligner().align(a, b)
        want = oracle_align(a, b)
        assert got.chain == want.chain
        assert got.aligned_a == want.aligned_a


def test_native_walk_batch_equals_python_fallback():
    """The threaded native batch walk must emit chains byte-identical to
    the per-pair Python walk, for both parity and full modes."""
    from cse305_parallel_sequence_alignment.models.batch import (
        BatchAligner,
    )
    rng = np.random.default_rng(29)
    pairs = []
    for _ in range(9):
        m = int(rng.integers(5, 50))
        n = int(rng.integers(5, 50))
        pairs.append(("".join(rng.choice(list("ACGT"), m)),
                      "".join(rng.choice(list("ACGT"), n))))
    for mode, offsets in (("parity", None),
                          ("full", [(10 * k, 3 * k)
                                    for k in range(len(pairs))])):
        native = BatchAligner().align_batch(
            pairs, offsets=offsets, traceback_mode=mode)
        orig = walker.walk_batch
        walker.walk_batch = lambda *a, **k: None
        try:
            fallback = BatchAligner().align_batch(
                pairs, offsets=offsets, traceback_mode=mode)
        finally:
            walker.walk_batch = orig
        for rn, rf in zip(native, fallback):
            assert rn.chain == rf.chain
            assert rn.score == rf.score and rn.end_table == rf.end_table


def test_native_render():
    chain = [(1, 1, 1), (2, 2, 1), (0, 3, 2), (3, 4, 1), (4, 5, 1)]
    tt = [t for (_, _, t) in chain]
    ii = [i for (i, _, _) in chain]
    jj = [j for (_, j, _) in chain]
    out = walker.render(
        np.frombuffer(b"AGGA", np.uint8),
        np.frombuffer(b"AGTGC", np.uint8), tt, ii, jj)
    assert out == ("AG-GA", "AGTGC")


def test_native_fasta_parse():
    data = b">seq1 desc\nACGT\nTTAA\n>seq2\nGGGG\n"
    names, seqs = walker.fasta_parse(data)
    assert names == [">seq1 desc", ">seq2"]
    assert seqs == ["ACGTTTAA", "GGGG"]


def test_native_fasta_on_reference_data(tmp_path):
    """The native scanner on a FASTA file shaped like the reference
    dataset (20 genes, 70-column bodies), written from the seeded
    generator."""
    from cse305_parallel_sequence_alignment.utils.synth import (
        gene_family,
        write_fasta,
    )
    names0, seqs0 = gene_family(count=20, min_len=500, max_len=3000,
                                seed=5)
    path = tmp_path / "genes.fa"
    write_fasta(path, names0, seqs0)
    names, seqs = walker.fasta_parse(path.read_bytes())
    assert (names, seqs) == (names0, seqs0)
    assert len(names) == len(seqs) == 20
    assert len(set(seqs)) == 20  # no duplicates (pull_data.cpp:54-68)
    assert all(s and set(s) <= set("ACGTN") for s in seqs)


def test_native_replay_rle_matches_numpy():
    """tsa_replay_rle_batch == expand_rle_ops + replay_ops on random
    walks, parity and full modes, with and without offsets."""
    import numpy as np

    from cse305_parallel_sequence_alignment.native import walker
    from cse305_parallel_sequence_alignment.ops.device_walk import (
        expand_rle_ops,
        replay_ops,
    )

    if not walker.available():
        import pytest
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(47)
    B = 6
    la = rng.integers(3, 60, B).astype(np.int64)
    lb = rng.integers(3, 70, B).astype(np.int64)
    t0 = rng.integers(1, 4, B).astype(np.int64)
    # synthesize valid RLE entry streams by simulating random walks
    entries = np.zeros((B, 80), np.uint8)
    for r in range(B):
        i, j, e = la[r], lb[r], 0
        while i > 0 and j > 0 and e < 80:
            k = int(rng.integers(0, min(i, j) + 1))
            op = int(rng.integers(1, 4))
            entries[r, e] = op | (k << 2)
            e += 1
            i -= k
            j -= k
            if i <= 0 or j <= 0:
                break
            if op == 1:
                i, j = i - 1, j - 1
            elif op == 2:
                j -= 1
            else:
                i -= 1
    offsets = [(int(rng.integers(0, 100)), int(rng.integers(0, 100)))
               for _ in range(B)]
    chunk = list(range(B))
    max_steps = int(la.max() + lb.max()) + 1
    for mode in ("parity", "full"):
        for offs in (None, offsets):
            ch = chunk if offs is not None else None
            want = replay_ops(expand_rle_ops(entries, max_steps),
                              la, lb, t0, mode=mode, offsets=offs,
                              chunk=ch)
            got = walker.replay_rle(entries, la, lb,
                                    t0.astype(np.int32), mode,
                                    offsets=offs, chunk=ch)
            wt, wi, wj, wl = want
            gt, gi, gj, gl = got
            assert np.array_equal(wl, gl), (mode, offs is None)
            for r in range(B):
                L = int(wl[r])
                assert np.array_equal(wt[r, :L], gt[r, :L]), (mode, r)
                assert np.array_equal(wi[r, :L], gi[r, :L]), (mode, r)
                assert np.array_equal(wj[r, :L], gj[r, :L]), (mode, r)
