"""Seeded homologous DNA: the repo's input data, made at run time.

A pair is an ancestor and a copy of it mutated at given substitution
and indel rates; a family is several mutated copies of one ancestor,
the shape of the reference's gene dataset (20 related genes of
13-97 kb). Everything follows from the seed, so tests, the benchmark
and the CLI need no downloaded file.
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)

# lengths of the reference's gene dataset: the family below spans the
# same range, its longest member exactly as long as the longest gene
REF_MIN_LEN = 13_000
REF_MAX_LEN = 97_409


def random_dna(rng, length):
    """uint8 array of ``length`` uniform ACGT bases."""
    return BASES[rng.integers(0, 4, length)]


def mutate(seq, sub_rate, indel_rate, rng):
    """A copy of uint8 ``seq`` with each base substituted (by a
    different base) at ``sub_rate``, and at each position a one-base
    deletion or insertion at ``indel_rate`` / 2 each."""
    seq = np.asarray(seq, np.uint8)
    n = seq.shape[0]
    out = seq.copy()
    sub = rng.random(n) < sub_rate
    code = np.searchsorted(BASES, out[sub])
    out[sub] = BASES[(code + rng.integers(1, 4, int(sub.sum()))) % 4]
    u = rng.random(n)
    keep = u >= indel_rate / 2
    insert = u >= 1.0 - indel_rate / 2
    reps = keep.astype(np.int64) + insert
    res = np.repeat(out, reps)
    # the second copy of each doubled base becomes a random base
    ins_at = np.cumsum(reps)[insert] - 1
    res[ins_at] = random_dna(rng, ins_at.shape[0])
    return res


def homologous_pair(length, sub_rate=0.05, indel_rate=0.01, seed=0):
    """(a, b) ASCII strings: a random ancestor of ``length`` bases and
    its mutated copy."""
    rng = np.random.default_rng(seed)
    a = random_dna(rng, length)
    b = mutate(a, sub_rate, indel_rate, rng)
    return a.tobytes().decode(), b.tobytes().decode()


def homologous_pairs(count, length, sub_rate=0.05, indel_rate=0.01,
                     seed=0):
    """``count`` independent homologous pairs of ~``length`` bases."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(count):
        a = random_dna(rng, length)
        b = mutate(a, sub_rate, indel_rate, rng)
        pairs.append((a.tobytes().decode(), b.tobytes().decode()))
    return pairs


def gene_family(count=20, min_len=REF_MIN_LEN, max_len=REF_MAX_LEN,
                sub_rate=0.05, indel_rate=0.01, seed=0):
    """(names, sequences): ``count`` distinct genes, mutated copies of
    prefixes of one ancestor, lengths spread over [min_len, max_len]
    with the first gene exactly ``max_len`` long."""
    rng = np.random.default_rng(seed)
    ancestor = random_dna(rng, max_len)
    lengths = np.linspace(max_len, min_len, count).astype(np.int64)
    seqs = [ancestor.tobytes().decode()]
    for L in lengths[1:]:
        seqs.append(mutate(ancestor[:L], sub_rate, indel_rate,
                           rng).tobytes().decode())
    names = [f">gene{k} synthetic seed={seed}" for k in range(count)]
    return names, seqs


def write_fasta(path, names, seqs, width=70):
    """Write records as FASTA, bodies wrapped at ``width``."""
    with open(path, "w") as f:
        for name, s in zip(names, seqs):
            f.write(name + "\n")
            for k in range(0, len(s), width):
                f.write(s[k: k + width] + "\n")
