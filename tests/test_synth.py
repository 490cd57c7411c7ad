"""Seeded homologous-sequence generator (utils/synth.py)."""

import numpy as np
import pytest

from cse305_parallel_sequence_alignment.models.batch import BatchAligner
from cse305_parallel_sequence_alignment.utils.fasta import (
    read_and_store_sequences,
)
from cse305_parallel_sequence_alignment.utils.synth import (
    gene_family,
    homologous_pair,
    homologous_pairs,
    mutate,
    random_dna,
    write_fasta,
)


def test_same_seed_same_pairs():
    assert homologous_pair(500, seed=3) == homologous_pair(500, seed=3)
    assert homologous_pair(500, seed=3) != homologous_pair(500, seed=4)
    assert homologous_pairs(4, 100, seed=2) == \
        homologous_pairs(4, 100, seed=2)


@pytest.mark.parametrize("sub,indel", [(0.05, 0.01), (0.2, 0.0),
                                       (0.0, 0.1)])
def test_mutation_rates(sub, indel):
    """Measured rates match the requested ones on 200 kb (within 10%
    of the rate: the counts are binomial with ~10^4 events)."""
    rng = np.random.default_rng(7)
    seq = random_dna(rng, 200_000)
    out = mutate(seq, sub, indel, rng)
    # length change: insertions minus deletions, zero in expectation
    assert abs(len(out) - len(seq)) < 5 * np.sqrt(indel * len(seq) + 1)
    if indel == 0.0:
        assert np.isclose((out != seq).mean(), sub, rtol=0.1)
    if sub == 0.0:
        # every indel shifts the copy; the fraction of shifted
        # positions is large, but bases stay in the alphabet
        assert set(np.unique(out)) <= set(b"ACGT")


def test_zero_rates_copy():
    rng = np.random.default_rng(1)
    seq = random_dna(rng, 1000)
    assert np.array_equal(mutate(seq, 0.0, 0.0, rng), seq)


def test_gene_family_shape():
    names, seqs = gene_family(count=6, min_len=1000, max_len=9000,
                              seed=2)
    assert len(names) == len(seqs) == 6 == len(set(seqs))
    assert len(seqs[0]) == 9000
    assert all(800 < len(s) <= 9300 for s in seqs)
    assert all(set(s) <= set("ACGT") for s in seqs)


def test_fasta_round_trip(tmp_path):
    names, seqs = gene_family(count=3, min_len=100, max_len=300, seed=6)
    write_fasta(tmp_path / "g.fa", names, seqs, width=60)
    got = read_and_store_sequences(tmp_path / "g.fa")
    assert (got.names, got.sequences) == (names, seqs)
    assert not got.has_duplicates


def test_homologous_pairs_align_better_than_random():
    """A 5% / 1% mutated copy scores far above an unrelated pair."""
    hom = homologous_pairs(2, 300, seed=12)
    rng = np.random.default_rng(13)
    rand = [(random_dna(rng, 300).tobytes().decode(),
             random_dna(rng, 300).tobytes().decode()) for _ in range(2)]
    s_hom, _ = BatchAligner().score_batch(hom)
    s_rand, _ = BatchAligner().score_batch(rand)
    assert s_hom.min() > 240 > 200 > s_rand.max()
