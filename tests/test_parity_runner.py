"""Live parity vs the repaired reference binary (built on the fly).

Skipped when the reference tree or a C++ toolchain is unavailable; the
offline golden cases (tests/golden/cases.jsonl) cover parity in that case.
"""

import numpy as np
import pytest

from cse305_parallel_sequence_alignment.harness.parity import (
    build_reference,
    build_subproblem_driver,
    reference_subproblem,
    run_parity,
    sample_dataset_pairs,
)

driver = build_reference(work_dir="/tmp/refparity_shared")

pytestmark = pytest.mark.skipif(
    driver is None, reason="reference binary unavailable")


def _genes():
    """The seeded gene family standing in for the reference dataset."""
    from cse305_parallel_sequence_alignment.utils.synth import gene_family
    return gene_family(seed=0)[1]


def test_live_parity_on_dataset_samples():
    pairs = sample_dataset_pairs(
        _genes(), count=6, max_len=120,
        seed=123)
    ok, mismatches = run_parity(pairs, driver=driver)
    assert ok, mismatches


def test_live_parity_kb_scale():
    """Byte parity at kb scale (1.2 kb x 1.5 kb dataset slices) — the
    regime where engine disagreements (tie-breaks, boundary handling)
    would actually surface."""
    seqs = _genes()
    pairs = [(seqs[3][:1200], seqs[11][:1500]),
             (seqs[8][:1000], seqs[8][500:1500])]
    ok, mismatches = run_parity(pairs, driver=driver)
    assert ok, [(m["a"][:40], m["b"][:40]) for m in mismatches]


def test_live_parity_equal_lengths():
    pairs = sample_dataset_pairs(
        _genes(), count=4, max_len=80,
        seed=7)
    pairs = [(a[: min(len(a), len(b))], b[: min(len(a), len(b))])
             for a, b in pairs]
    ok, mismatches = run_parity(pairs, driver=driver)
    assert ok, mismatches


def test_live_parity_multi_kb():
    """Byte parity at 4-5 kb dataset slices (-O2 reference, p=1 serial
    fill) — tie-break divergences are most likely to surface at scale."""
    seqs = _genes()
    pairs = [(seqs[5][:4096], seqs[13][:5000]),
             (seqs[17][2000:6500], seqs[2][:4600])]
    ok, mismatches = run_parity(pairs, driver=driver, p=1)
    assert ok, [(m["a"][:40], m["b"][:40]) for m in mismatches]


@pytest.mark.parametrize("start,end", [
    (-1, -1), (-2, -1), (-3, -2), (-1, -3), (2, 1), (3, 2), (1, 3),
])
def test_live_subproblem_boundary_types(start, end):
    """Anchored-segment semantics: drive the reference Subproblem with
    non-trivial start/end types and byte-pin finals + chain — exactly
    what partition stitching relies on (subproblem_alignment.h:36-74,
    main_alignment.cpp:250-251)."""
    subp = build_subproblem_driver(work_dir="/tmp/refparity_shared")
    assert subp is not None
    from cse305_parallel_sequence_alignment.models.batch import (
        BatchAligner,
    )
    rng = np.random.default_rng(1000 + 100 * (start + 3) + (end + 3))
    m = int(rng.integers(30, 70))
    n = m + int(rng.integers(0, 25))
    a = "".join(rng.choice(list("ACGT"), m))
    b = "".join(rng.choice(list("ACGT"), n))
    finals, ref_chain = reference_subproblem(subp, a, b, start=start,
                                             end=end)
    al = BatchAligner(start_type=start, end_type=end)
    res = al.align_batch([(a, b)])[0]
    ours = al._finals(*_enc_pair(a, b))
    np.testing.assert_array_equal(np.asarray(ours)[0], finals)
    assert list(res.chain) == ref_chain, (start, end)


def _enc_pair(a, b):
    from cse305_parallel_sequence_alignment.core import encode_seq
    ea, eb = encode_seq(a), encode_seq(b)
    return (ea[None, :], eb[None, :],
            np.array([len(ea)], np.int32), np.array([len(eb)], np.int32))


def test_live_parity_8kb():
    """Byte parity at 8-9 kb: the -O2 reference at
    p=1 allocates 3 double tables (~1.9 GB at this size); measured
    ~17 s end to end, cheap enough for every CI run."""
    seqs = _genes()
    pairs = [(seqs[5][:8192], seqs[13][:9000])]
    ok, mismatches = run_parity(pairs, driver=driver, p=1)
    assert ok, [(m["a"][:40], m["b"][:40]) for m in mismatches]


@pytest.mark.slow
def test_live_parity_14kb():
    """Byte parity at 13 x 14 kb (one notch past the 8-9 kb pin). The -O2 reference at p=1 allocates 3 double tables
    (~4.5 GB here — fine on this VM's 125 GB); its serial fill is the
    cost (~1 min), so the case is marked slow and runs in the full
    suite only."""
    seqs = _genes()
    # the shortest (13 kb) gene whole against a 14 kb slice
    order = sorted(range(len(seqs)), key=lambda k: len(seqs[k]))
    short = seqs[order[0]]
    other = seqs[order[-1]][:14000]
    assert len(short) <= len(other)
    ok, mismatches = run_parity([(short, other)], driver=driver, p=1)
    assert ok, [(m["a"][:40], m["b"][:40]) for m in mismatches]


@pytest.mark.slow
def test_live_parity_22kb():
    """Byte parity at 20 x 22 kb (past 14 kb). The -O2 reference at p=1 allocates 3 double tables
    (~10.6 GB here — the 125 GB VM takes it); its serial fill is the
    cost (several minutes), so the case runs in the full suite only."""
    seqs = _genes()
    order = sorted(range(len(seqs)), key=lambda k: len(seqs[k]))
    a = seqs[order[-2]][:20000]
    b = seqs[order[-1]][:22000]
    ok, mismatches = run_parity([(a, b)], driver=driver, p=1)
    assert ok, [(m["a"][:40], m["b"][:40]) for m in mismatches]
