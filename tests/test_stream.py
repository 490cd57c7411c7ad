"""Streaming engine: chunking, resume, multi-host striping, observability."""


import numpy as np

from cse305_parallel_sequence_alignment.harness.stream import (
    StreamRunner,
)
from cse305_parallel_sequence_alignment.models.batch import BatchAligner
from cse305_parallel_sequence_alignment.models.oracle import oracle_align
from cse305_parallel_sequence_alignment.parallel.multihost import (
    host_shard,
)
from cse305_parallel_sequence_alignment.utils.observability import (
    PhaseTimer,
    gcups,
)


def make_stream(rng, count, lo=10, hi=40):
    for k in range(count):
        m = int(rng.integers(lo, hi))
        n = int(rng.integers(lo, hi))
        yield (f"p{k}", "".join(rng.choice(list("ACGT"), m)),
               "".join(rng.choice(list("ACGT"), n)))


def read_scores(path):
    rows = {}
    with open(path) as f:
        next(f)
        for line in f:
            pid, score, table = line.strip().split(",")
            rows[pid] = float(score)
    return rows


def test_stream_scores_match_oracle(tmp_path):
    rng = np.random.default_rng(41)
    items = list(make_stream(rng, 10))
    runner = StreamRunner(out_dir=str(tmp_path), chunk_size=4)
    man = runner.run(iter(items))
    assert man["pairs"] == 10
    rows = read_scores(runner.scores_path)
    assert len(rows) == 10
    for (pid, a, b) in items:
        assert rows[pid] == oracle_align(a, b).score, pid


def test_stream_resume_skips_done_chunks(tmp_path):
    rng = np.random.default_rng(42)
    items = list(make_stream(rng, 12))

    class Counting(BatchAligner):
        calls = 0

        def score_batch(self, pairs):
            Counting.calls += 1
            return super().score_batch(pairs)

    r1 = StreamRunner(out_dir=str(tmp_path), chunk_size=4,
                      aligner=Counting())
    # simulate an interrupted run: only the first chunk of the stream
    r1.run(iter(items[:4]))
    assert Counting.calls == 1
    # full replay: chunk 0 must be skipped, chunks 1-2 run
    man = StreamRunner(out_dir=str(tmp_path), chunk_size=4,
                       aligner=Counting()).run(iter(items))
    assert Counting.calls == 3
    assert sorted(man["done_chunks"]) == [0, 1, 2]
    rows = read_scores(r1.scores_path)
    assert len(rows) == 12


def test_stream_multihost_striping(tmp_path):
    rng = np.random.default_rng(43)
    items = list(make_stream(rng, 16))
    for p in (0, 1):
        StreamRunner(out_dir=str(tmp_path), chunk_size=4,
                     process_index=p, process_count=2).run(iter(items))
    r0 = read_scores(tmp_path / "scores_p0.csv")
    r1 = read_scores(tmp_path / "scores_p1.csv")
    assert len(r0) == 8 and len(r1) == 8
    assert set(r0) | set(r1) == {f"p{k}" for k in range(16)}
    assert not (set(r0) & set(r1))


def test_stream_resume_config_mismatch_rejected(tmp_path):
    import pytest as _pytest

    rng = np.random.default_rng(44)
    items = list(make_stream(rng, 4))
    StreamRunner(out_dir=str(tmp_path), chunk_size=4).run(iter(items))
    with _pytest.raises(ValueError, match="config mismatch"):
        StreamRunner(out_dir=str(tmp_path), chunk_size=2).run(iter(items))


def test_stream_merge_shards(tmp_path):
    rng = np.random.default_rng(45)
    items = list(make_stream(rng, 12))
    for p in (0, 1):
        StreamRunner(out_dir=str(tmp_path), chunk_size=4,
                     process_index=p, process_count=2).run(iter(items))
    dest, n = StreamRunner.merge(str(tmp_path))
    assert n == 12
    rows = read_scores(dest)
    assert len(rows) == 12


def test_host_shard_partitions_everything():
    for count in (0, 1, 7, 16):
        for pc in (1, 2, 3, 5):
            seen = []
            for pi in range(pc):
                seen.extend(host_shard(count, pi, pc))
            assert sorted(seen) == list(range(count)), (count, pc)


def test_phase_timer_and_gcups():
    t = PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    assert t.counts["a"] == 2 and t.totals["a"] >= 0.0
    assert gcups(2_000_000_000, 2.0) == 1.0
