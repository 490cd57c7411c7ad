"""Performance report: GCUPS across problem sizes, batch sizes, modes.

The roofline-style study from SURVEY.md §7.2 step 7: sweeps the batched
fill across (length, batch) grids for the global and local engines, plus
the column-sharded long-pair pipeline, and emits structured JSON rows
(one per configuration). Each row names the platform it ran on; only a
GPU row is a device measurement.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from cse305_parallel_sequence_alignment.utils.observability import gcups

def _rand_batch(rng, batch, m, n):
    a = rng.integers(65, 69, size=(batch, m)).astype(np.uint8)
    b = rng.integers(65, 69, size=(batch, n)).astype(np.uint8)
    la = np.full((batch,), m, np.int32)
    lb = np.full((batch,), n, np.int32)
    return a, b, la, lb


def _time_call(fn, iters=3):
    fn()  # warmup / compile
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return (time.perf_counter() - t0) / iters, out


def run_report(lengths=(512, 2048), batches=(64, 256), iters=3,
               include_longseq=True, stream=None):
    """Run the sweep; prints one JSON line per config and returns rows."""
    import jax

    from cse305_parallel_sequence_alignment.models.batch import (
        BatchAligner,
    )
    from cse305_parallel_sequence_alignment.models.local import (
        LocalBatchAligner,
    )

    out = stream or sys.stdout
    backend = jax.default_backend()
    rng = np.random.default_rng(17)
    rows = []

    def emit(row):
        row["backend"] = backend
        # rows time the full harness call: host packing, upload, fill
        # and the sync that fetches the result
        rows.append(row)
        print(json.dumps(row), file=out, flush=True)

    ga = BatchAligner()
    la_ = LocalBatchAligner()
    for L in lengths:
        for B in batches:
            a, b, laa, lbb = _rand_batch(rng, B, L, L)
            dt, _ = _time_call(lambda: ga._finals(a, b, laa, lbb), iters)
            emit({"mode": "global_score", "len": L, "batch": B,
                  "seconds": round(dt, 4),
                  "gcups": round(gcups(B * L * L, dt), 3)})
            dt, _ = _time_call(lambda: la_._best(a, b, laa, lbb), iters)
            emit({"mode": "local_score", "len": L, "batch": B,
                  "seconds": round(dt, 4),
                  "gcups": round(gcups(B * L * L, dt), 3)})

    # full-alignment end-to-end (fill + device walk + replay + render)
    L, B = max(lengths), min(batches)
    a, b, laa, lbb = _rand_batch(rng, B, L, L)
    pairs = [(p0.tobytes().decode(), p1.tobytes().decode())
             for p0, p1 in zip(a, b)]
    dt, res = _time_call(lambda: ga.align_batch(pairs), iters)
    assert all(r.aligned_a for r in res)
    emit({"mode": "global_align_e2e", "len": L, "batch": B,
          "seconds": round(dt, 4), "pairs_per_s": round(B / dt, 1),
          "gcups": round(gcups(B * L * L, dt), 3)})

    if include_longseq:
        from cse305_parallel_sequence_alignment.core import (
            ScoringParams,
        )
        from cse305_parallel_sequence_alignment.parallel.longseq import (
            longseq_pipeline_stats,
            longseq_score,
        )
        L = max(lengths) * 4
        aa = rng.integers(65, 69, size=(L,)).astype(np.uint8)
        bb = rng.integers(65, 69, size=(L,)).astype(np.uint8)
        dt, _ = _time_call(
            lambda: longseq_score(aa, bb, ScoringParams(), row_chunk=256),
            max(1, iters - 1))
        row = {"mode": "longseq_score", "len": L,
               "devices": jax.device_count(), "seconds": round(dt, 4),
               "gcups": round(gcups(L * L, dt), 3)}
        row.update({"pipeline_" + k: v for k, v in
                    longseq_pipeline_stats(L, L, jax.device_count(),
                                           row_chunk=256).items()
                    if k != "devices"})
        emit(row)
        # degenerate 1-device mesh: isolates pipeline overhead (the gap
        # to the same-length rowscan row above is scan/halo machinery,
        # not parallelism)
        from jax.sharding import Mesh
        mesh1 = Mesh(np.array(jax.devices()[:1]), ("seq",))
        dt1, _ = _time_call(
            lambda: longseq_score(aa, bb, ScoringParams(), mesh=mesh1,
                                  row_chunk=256), 1)
        emit({"mode": "longseq_score_1dev", "len": L, "devices": 1,
              "seconds": round(dt1, 4),
              "gcups": round(gcups(L * L, dt1), 3)})
    return rows


if __name__ == "__main__":
    run_report()
