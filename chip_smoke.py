"""Smoke test of the aligner's main path on NVIDIA GPUs.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --gpus 4   # four GPUs: the sharded paths only

One process drives the card(s); the pure-Python oracles run beside it
in CPU-only worker processes. Inputs are seeded homologous DNA
(utils/synth.py), scoring the reference's (match 1, mismatch 0, gap
open 2, extend 1) unless a mode has its own defaults.

One-GPU phases:

0. the ``gpu``-marked tests (the fill kernel compiled for the card);
1. ``align_pairs`` on 256 pairs of ~2 kb: scores, chains and rows equal
   the oracle on 8 pairs; all 256 scores equal ``score_pairs`` and the
   XLA wavefront's;
2. ``score_pairs`` at 256 x ~2 kb and 16,384 x ~256 bp, kernel beside
   XLA, with cells per second;
3. local, semi-global, overlap and banded modes on 64 pairs of ~1 kb
   each, equal to their oracles;
4. ``PartitionedAligner`` on one 97,409 nt pair (the reference
   dataset's longest gene): score equal to the row scan of the whole
   pair; cold and warm seconds.

Four-GPU phases: ``_sharded_score`` on 4 x 256 pairs of ~2 kb,
``longseq_score`` on the 97 kb pair and ``PartitionedAligner`` with the
sharded crossing search, each compared with its one-card result.

Every line before the last names the card and its power limit; the last
line is ``{"ok": true, "device": {...}}``. Any failed phase, or no GPU,
exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import pathlib
import subprocess
import sys
import time
import traceback

REPO = pathlib.Path(__file__).resolve().parent
LONG = 97_409  # the reference dataset's longest gene
SEED = 2026


def oracle_job(job):
    """Pure-Python oracle of one pair; runs in a CPU-only worker."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(REPO))
    mode, a, b = job
    if mode == "global":
        from cse305_parallel_sequence_alignment.models.oracle import (
            oracle_align,
        )
        r = oracle_align(a, b)
        return r.score, list(r.chain), r.aligned_a, r.aligned_b
    if mode == "banded":
        from cse305_parallel_sequence_alignment.models.oracle import (
            oracle_align,
        )
        r = oracle_align(a, b, parity_swap=False)
        return r.score, list(r.chain)
    if mode == "local":
        from cse305_parallel_sequence_alignment.models.local_oracle import (
            sw_oracle_align,
        )
        score, chain = sw_oracle_align(a, b)
        return score, list(chain)
    if mode == "semiglobal":
        from cse305_parallel_sequence_alignment.core import ScoringParams
        from cse305_parallel_sequence_alignment.models.semiglobal import (
            sg_oracle_best,
        )
        return sg_oracle_best(a, b, ScoringParams(mismatch=-1.0))
    from cse305_parallel_sequence_alignment.models.overlap import (
        ov_oracle_best,
    )
    return ov_oracle_best(a, b)


class Smoke:
    """Runs phases, prints their numbers with the card, records
    failures."""

    def __init__(self, card):
        self.card = card
        self.failed = []

    def say(self, msg):
        print(f"[{self.card}] {msg}", flush=True)

    def phase(self, name, fn):
        t = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            self.failed.append(name)
            self.say(f"{name}: FAILED")
            return
        self.say(f"{name}: ok in {time.perf_counter() - t:.3f} s")


def timed(fn):
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def one_gpu(smoke, pool):
    import numpy as np

    from cse305_parallel_sequence_alignment import (
        align,
        align_pairs,
        score_pairs,
    )
    from cse305_parallel_sequence_alignment.ops.rowscan import (
        rowscan_score,
    )
    from cse305_parallel_sequence_alignment.parallel.partition import (
        PartitionedAligner,
    )
    from cse305_parallel_sequence_alignment.utils.synth import (
        homologous_pair,
        homologous_pairs,
    )

    pairs2k = homologous_pairs(256, 2000, seed=SEED)
    modes = ("local", "semiglobal", "overlap", "banded")
    pairs1k = {m: homologous_pairs(64, 1000, seed=SEED + k + 1)
               for k, m in enumerate(modes)}
    # the oracles take seconds per pair: start them now, check later
    jobs = [("global", a, b) for a, b in pairs2k[:8]]
    for m in modes:
        jobs += [(m, a, b) for a, b in pairs1k[m]]
    pending = pool.map_async(oracle_job, jobs, chunksize=1)
    got = {}

    def gpu_tests():
        import pytest
        os.environ["JAX_PLATFORMS"] = "cuda"  # conftest keeps the card
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          str(REPO / "tests" / "test_gpu_fill.py")])
        check(rc == 0, f"gpu-marked tests: pytest exit {int(rc)}")

    def align_2k():
        res, cold = timed(lambda: align_pairs(pairs2k))
        res, warm = timed(lambda: align_pairs(pairs2k))
        smoke.say(f"align_pairs 256 x 2 kb: cold {cold:.3f} s, warm "
                  f"{warm:.4f} s, {len(res) / warm:.1f} pairs/s")
        sk, _ = score_pairs(pairs2k)
        sx, _ = score_pairs(pairs2k, backend="wavefront")
        scores = np.array([r.score for r in res], np.float32)
        check(np.array_equal(scores, sk), "align scores != score_pairs")
        check(np.array_equal(sk, sx), "kernel scores != XLA wavefront")
        check(all(r.aligned_a and len(r.aligned_a) == len(r.aligned_b)
                  for r in res), "rendered rows malformed")
        got["global"] = [(r.score, list(r.chain), r.aligned_a,
                          r.aligned_b) for r in res[:8]]

    def score_rates():
        for count, length in ((256, 2000), (16384, 256)):
            pairs = (pairs2k if count == 256 else
                     homologous_pairs(count, length, seed=SEED + 9))
            cells = float(sum(len(a) * len(b) for a, b in pairs))
            row = {}
            for backend in ("kernel", "wavefront"):
                out, cold = timed(lambda: score_pairs(pairs,
                                                      backend=backend))
                warm = min(timed(lambda: score_pairs(
                    pairs, backend=backend))[1] for _ in range(3))
                row[backend] = out[0]
                smoke.say(f"score_pairs {count} x {length} bp "
                          f"{backend}: cold {cold:.3f} s, warm "
                          f"{warm:.4f} s, {cells / warm / 1e9:.2f} "
                          f"GCUPS")
            check(np.array_equal(row["kernel"], row["wavefront"]),
                  f"kernel != XLA scores at {count} x {length}")

    def other_modes():
        for m in ("local", "semiglobal", "overlap"):
            pairs = pairs1k[m]
            (res, cold) = timed(lambda: align_pairs(pairs, mode=m))
            sc, t = timed(lambda: score_pairs(pairs, mode=m))
            smoke.say(f"{m} 64 x 1 kb: align {cold:.3f} s, score "
                      f"{t:.3f} s")
            if m == "local":
                got[m] = [(r.score, list(r.chain)) for r in res]
            elif m == "semiglobal":
                got[m] = [(float(sc[0][k]), int(sc[1][k]), int(sc[2][k]))
                          for k in range(len(pairs))]
                check([r.score for r in res] == [g[0] for g in got[m]],
                      "semiglobal align != score")
            else:
                got[m] = [(float(sc[0][k]), int(sc[1][k]), int(sc[2][k]),
                           int(sc[3][k])) for k in range(len(pairs))]
                check([r.score for r in res] == [g[0] for g in got[m]],
                      "overlap align != score")
        res, t = timed(lambda: [align(a, b, mode="banded", band=64)
                                for a, b in pairs1k["banded"]])
        smoke.say(f"banded 64 x 1 kb (band 64): {t:.3f} s")
        got["banded"] = [(r.score, list(r.chain)) for r in res]

    def partition():
        a, b = homologous_pair(LONG, seed=SEED + 7)
        al = PartitionedAligner()
        r1, cold = timed(lambda: al.align(a, b))
        r2, warm = timed(lambda: al.align(a, b))
        want, t_row = timed(lambda: np.asarray(rowscan_score(
            np.frombuffer(min(a, b, key=len).encode(), np.uint8),
            np.frombuffer(max(a, b, key=len).encode(), np.uint8))))
        best = float(max(want[0], want[1], want[2]))
        smoke.say(f"PartitionedAligner {len(a)} x {len(b)} nt: cold "
                  f"{cold:.3f} s, warm {warm:.3f} s, score {r1.score}; "
                  f"whole-pair row scan {t_row:.3f} s, score {best}")
        check(r1.score == r2.score == best,
              f"partition score {r1.score} != row scan {best}")
        check(r1.aligned_a.replace("-", "") == min(a, b, key=len),
              "partition rows do not replay the sequence")

    smoke.phase("gpu-marked tests", gpu_tests)
    smoke.phase("align_pairs 256 x 2 kb", align_2k)
    smoke.phase("score_pairs rates", score_rates)
    smoke.phase("local/semiglobal/overlap/banded 64 x 1 kb", other_modes)
    smoke.phase("PartitionedAligner 97 kb", partition)

    def oracles():
        want = pending.get(timeout=900)
        k = 0
        for m in ("global",) + modes:
            n = 8 if m == "global" else 64
            w = want[k: k + n]
            k += n
            check(m in got, f"{m}: no device result to compare")
            bad = [i for i in range(n) if tuple(got[m][i]) != tuple(w[i])]
            check(not bad, f"{m}: pairs {bad[:8]} differ from the oracle")
            smoke.say(f"{m}: {n} pairs equal the oracle")

    smoke.phase("oracle comparison", oracles)


def four_gpus(smoke):
    import numpy as np

    from cse305_parallel_sequence_alignment.core import ScoringParams
    from cse305_parallel_sequence_alignment.models.batch import (
        BatchAligner,
    )
    from cse305_parallel_sequence_alignment.ops.rowscan import (
        rowscan_score,
    )
    from cse305_parallel_sequence_alignment.parallel.batch_shard import (
        ShardedBatchAligner,
    )
    from cse305_parallel_sequence_alignment.parallel.longseq import (
        longseq_score,
    )
    from cse305_parallel_sequence_alignment.parallel.mesh import (
        make_seq_mesh,
    )
    from cse305_parallel_sequence_alignment.parallel.partition import (
        PartitionedAligner,
    )
    from cse305_parallel_sequence_alignment.utils.synth import (
        homologous_pair,
        homologous_pairs,
    )

    a, b = homologous_pair(LONG, seed=SEED + 7)
    sa, sb = min(a, b, key=len), max(a, b, key=len)
    ea = np.frombuffer(sa.encode(), np.uint8)
    eb = np.frombuffer(sb.encode(), np.uint8)

    def data_parallel():
        pairs = homologous_pairs(4 * 256, 2000, seed=SEED)
        (s4, _), t4 = timed(lambda: ShardedBatchAligner(
            num_devices=4).score_batch(pairs))
        (s4, _), t4w = timed(lambda: ShardedBatchAligner(
            num_devices=4).score_batch(pairs))
        (s1, _), t1 = timed(lambda: BatchAligner().score_batch(pairs))
        (s1, _), t1w = timed(lambda: BatchAligner().score_batch(pairs))
        smoke.say(f"_sharded_score (XLA) 4 x 256 x 2 kb: 4 GPUs "
                  f"{t4w:.4f} s (cold {t4:.3f}); 1 GPU kernel "
                  f"{t1w:.4f} s (cold {t1:.3f})")
        check(np.array_equal(s4, s1), "4-GPU scores != 1-GPU scores")

    def long_pipeline():
        want, t1 = timed(lambda: np.asarray(rowscan_score(ea, eb)))
        got, cold = timed(lambda: longseq_score(
            ea, eb, ScoringParams(), mesh=make_seq_mesh(4),
            row_chunk=256))
        got, warm = timed(lambda: longseq_score(
            ea, eb, ScoringParams(), mesh=make_seq_mesh(4),
            row_chunk=256))
        smoke.say(f"longseq_score {len(ea)} x {len(eb)} nt: 4 GPUs "
                  f"{warm:.3f} s (cold {cold:.3f}), 1 GPU row scan "
                  f"{t1:.3f} s")
        check(np.array_equal(np.asarray(got), want),
              f"longseq {got} != row scan {want}")

    def partition_sharded():
        r1, t1 = timed(lambda: PartitionedAligner().align(a, b))
        al = PartitionedAligner(fill_backend="sharded",
                                mesh=make_seq_mesh(4))
        r4, cold = timed(lambda: al.align(a, b))
        r4, warm = timed(lambda: al.align(a, b))
        smoke.say(f"PartitionedAligner sharded, 4 GPUs: {warm:.3f} s "
                  f"(cold {cold:.3f}); 1 GPU {t1:.3f} s; scores "
                  f"{r4.score} / {r1.score}")
        check(r4.score == r1.score, "sharded partition score differs")
        check(list(r4.chain) == list(r1.chain),
              "sharded partition chain differs")

    smoke.phase("data-parallel score, 4 GPUs", data_parallel)
    smoke.phase("longseq_score 97 kb, 4 GPUs", long_pipeline)
    smoke.phase("PartitionedAligner sharded, 4 GPUs", partition_sharded)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--gpus", type=int, choices=(1, 4), default=1)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(REPO))

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX platform "
                 f"{devices[0].platform!r})")
    if len(devices) < args.gpus:
        sys.exit(f"chip_smoke: --gpus {args.gpus} but JAX sees "
                 f"{len(devices)} GPUs")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    smoke = Smoke(card)
    smoke.say(f"JAX {jax.__version__}, {len(devices)} x "
              f"{devices[0].device_kind}")
    if args.gpus == 4:
        four_gpus(smoke)
    else:
        workers = max(1, min(14, (os.cpu_count() or 2) - 2))
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            one_gpu(smoke, pool)
    if smoke.failed:
        sys.exit(f"chip_smoke: failed phases: {smoke.failed}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
