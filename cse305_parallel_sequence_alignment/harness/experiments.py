"""The reference harness's three experiments (C10), batched on device.

Reference behaviors reproduced deliberately:
- pair selection uses ``rand() % (dataset_size - 1)`` — note the ``- 1``:
  the last sequence is never drawn (testing.cpp:96,115-116). We keep the
  same modulus with a seeded PRNG (the reference's rand() is unseeded,
  quirk B11; seeding is the sane replacement).
- input-size experiment truncates both sequences to min(input_size,
  min length) and aligns at equal lengths (testing.cpp:120-134).
- CSV schemas are byte-compatible (utils/csvio.py).

What is NOT reproduced: per-pair std::thread dispatch. Pairs are batched
and length-bucketed; per-pair wall time is the batch time divided by the
pairs that shared the launch (the honest device-time attribution).
"""

from __future__ import annotations

import os
import time

import numpy as np

from cse305_parallel_sequence_alignment.models.batch import BatchAligner
from cse305_parallel_sequence_alignment.utils.config import RunConfig
from cse305_parallel_sequence_alignment.utils.csvio import (
    write_input_size_csv,
    write_n_cores_csv,
    write_similarity_csv,
)
from cse305_parallel_sequence_alignment.utils.similarity import (
    sequence_similarity,
)


def _pick_pairs(rng, sequences, count):
    """Reference pair selection: rand() % (len-1), twice per test."""
    rg = len(sequences) - 1
    idx1 = rng.integers(0, rg, size=count)
    idx2 = rng.integers(0, rg, size=count)
    return idx1, idx2


def _timed_scores(aligner, pairs):
    t0 = time.perf_counter()
    scores, _ = aligner.score_batch(pairs)
    dt = time.perf_counter() - t0
    return scores, dt


def _write_launch_meta(csv_path, aligner, total_pairs, dt,
                       launches=None):
    """Sidecar metadata next to each CSV: per-launch batch sizes (the
    CSV itself stays byte-compatible with the reference's schema, so
    attribution facts go in <name>.meta.json)."""
    import json
    if launches is None:
        launches = getattr(aligner, "last_launches", None) or []
    meta = {
        "total_pairs": total_pairs,
        "wall_s": dt,
        "per_pair_s": dt / max(total_pairs, 1),
        "launches": [{"padded_m": m, "padded_n": n, "batch": b}
                     for (m, n, b) in launches],
    }
    with open(csv_path[: -len(".csv")] + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)


def test_input_size(names, sequences, cfg: RunConfig = RunConfig(),
                    aligner: BatchAligner | None = None):
    """Input-size experiment -> input_size_testing.csv (testing.cpp:81-166).

    Returns the row list [(test_number, input_size, seconds)]."""
    rng = np.random.default_rng(cfg.seed)
    idx1, idx2 = _pick_pairs(rng, sequences, cfg.test_pairs)
    pairs, sizes = [], []
    for k in range(cfg.test_pairs):
        s1, s2 = sequences[idx1[k]], sequences[idx2[k]]
        L = min(cfg.input_size, len(s1), len(s2))
        pairs.append((s1[:L], s2[:L]))
        sizes.append(L)
    aligner = aligner or BatchAligner(
        params=cfg.params, bucket_quantum=cfg.bucket_quantum,
        max_batch=cfg.max_batch)
    _, dt = _timed_scores(aligner, pairs)
    per = dt / max(len(pairs), 1)
    rows = [(j, sizes[j], per) for j in range(len(pairs))]
    path = os.path.join(cfg.out_dir, "input_size_testing.csv")
    write_input_size_csv(path, rows)
    _write_launch_meta(path, aligner, len(pairs), dt)
    return rows


def test_n_cores(names, sequences, cfg: RunConfig = RunConfig(),
                 n_cores_list=(1, 2, 4, 8), pairs_per_setting=None):
    """Core-count experiment -> n_cores_testing.csv (testing.cpp:209-287).

    Here "n cores" maps to the number of devices the batch is sharded
    over (parallel/batch_shard); with fewer devices than requested the
    setting records the request, mirroring the reference's behavior of
    passing any p through. Returns row list."""
    from cse305_parallel_sequence_alignment.parallel.batch_shard import (
        ShardedBatchAligner,
    )
    import jax

    rng = np.random.default_rng(cfg.seed)
    total = pairs_per_setting or max(
        1, cfg.n_cores_pairs // max(len(n_cores_list), 1))
    rows = []
    j = 0
    total_dt = 0.0
    all_launches = []
    for cores in n_cores_list:
        ndev = min(cores, jax.device_count())
        aligner = ShardedBatchAligner(
            params=cfg.params, bucket_quantum=cfg.bucket_quantum,
            max_batch=cfg.max_batch, num_devices=ndev)
        idx1, idx2 = _pick_pairs(rng, sequences, total)
        pairs = []
        for k in range(total):
            s1, s2 = sequences[idx1[k]], sequences[idx2[k]]
            L = min(cfg.input_size, len(s1), len(s2))
            pairs.append((s1[:L], s2[:L]))
        _, dt = _timed_scores(aligner, pairs)
        total_dt += dt
        all_launches.extend(getattr(aligner, "last_launches", None) or [])
        per = dt / max(len(pairs), 1)
        for _ in range(total):
            rows.append((j, cores, per))
            j += 1
    path = os.path.join(cfg.out_dir, "n_cores_testing.csv")
    write_n_cores_csv(path, rows)
    # launches accumulated across ALL per-setting aligners and the real
    # summed wall time (a stale last-loop aligner + dt=0.0 made the
    # sidecar meaningless before)
    _write_launch_meta(path, None, total * len(n_cores_list), total_dt,
                       launches=all_launches)
    return rows


def test_similarity(names, sequences, cfg: RunConfig = RunConfig(),
                    aligner: BatchAligner | None = None):
    """Similarity experiment -> similarity_testing.csv
    (testing.cpp:295-369). Returns row list.

    Unlike the input-size experiment, the reference aligns similarity
    pairs at the FULL min length (``input_size_min = minlen``,
    testing.cpp:333-345) — the default here matches that. Set
    ``cfg.similarity_input_size > 0`` to truncate instead (the
    pre-round-4 behavior, which silently reused ``cfg.input_size``)."""
    rng = np.random.default_rng(cfg.seed)
    count = cfg.similarity_pairs
    idx1, idx2 = _pick_pairs(rng, sequences, count)
    pairs, sims = [], []
    for k in range(count):
        s1, s2 = sequences[idx1[k]], sequences[idx2[k]]
        L = min(len(s1), len(s2))
        if cfg.similarity_input_size > 0:
            L = min(cfg.similarity_input_size, L)
        pairs.append((s1[:L], s2[:L]))
        sims.append(sequence_similarity(s1, s2))
    aligner = aligner or BatchAligner(
        params=cfg.params, bucket_quantum=cfg.bucket_quantum,
        max_batch=cfg.max_batch)
    _, dt = _timed_scores(aligner, pairs)
    per = dt / max(len(pairs), 1)
    rows = [(j, sims[j], per) for j in range(len(pairs))]
    path = os.path.join(cfg.out_dir, "similarity_testing.csv")
    write_similarity_csv(path, rows)
    _write_launch_meta(path, aligner, len(pairs), dt)
    return rows
