"""CLI entry point: ``python -m cse305_parallel_sequence_alignment``.

Counterpart of the reference's main.cpp (load FASTA, run the experiment
harness; main.cpp:6-21) widened into a real command surface:

  align        one global alignment (prints the reference's two-row format)
  local        one local (SW) alignment with CIGAR
  batch        score/align many pairs from a FASTA file
  experiment   the reference harness's three experiments -> CSVs
  partition    balanced-partition alignment of one pair (p segments)
  info         backend/devices/version
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from cse305_parallel_sequence_alignment import __version__
from cse305_parallel_sequence_alignment.utils.config import (
    RunConfig,
    add_config_args,
    config_from_args,
)


def _load_data(cfg: RunConfig):
    """(names, sequences): the FASTA file at ``--data``, or without it
    a seeded synthetic gene family shaped like the reference dataset."""
    if cfg.data_path:
        from cse305_parallel_sequence_alignment.utils.fasta import (
            read_and_store_sequences,
        )
        return read_and_store_sequences(cfg.data_path)
    from cse305_parallel_sequence_alignment.utils.synth import (
        gene_family,
    )
    return gene_family(seed=cfg.seed)


def _resolve_pair(args, cfg):
    """(a, b) from --a/--b literals or --pair indices into the dataset."""
    if args.a and args.b:
        return args.a, args.b
    names, seqs = _load_data(cfg)
    i, j = args.pair
    a, b = seqs[i], seqs[j]
    if args.truncate:
        a, b = a[: args.truncate], b[: args.truncate]
    return a, b


def cmd_align(args):
    cfg = config_from_args(args)
    a, b = _resolve_pair(args, cfg)
    from cse305_parallel_sequence_alignment.models import GotohAligner
    t0 = time.perf_counter()
    res = GotohAligner(params=cfg.params).align(a, b)
    dt = time.perf_counter() - t0
    print(res.aligned_a)
    print(res.aligned_b)
    if args.verbose:
        print(f"score={res.score} end_table={res.end_table} "
              f"time={dt:.4f}s", file=sys.stderr)
    return 0


def cmd_local(args):
    cfg = config_from_args(args)
    a, b = _resolve_pair(args, cfg)
    from cse305_parallel_sequence_alignment.models import (
        LocalBatchAligner,
    )
    from cse305_parallel_sequence_alignment.core import ScoringParams
    params = ScoringParams(g=cfg.g, h=cfg.h, match=args.sw_match,
                           mismatch=args.sw_mismatch)
    res = LocalBatchAligner(params=params).align_batch([(a, b)])[0]
    print(json.dumps({
        "score": res.score,
        "cigar": res.cigar,
        "cigar_extended": res.cigar_extended,
        "query_span": [res.start_a, res.end_a],
        "target_span": [res.start_b, res.end_b],
    }))
    return 0


def cmd_semiglobal(args):
    cfg = config_from_args(args)
    a, b = _resolve_pair(args, cfg)
    from cse305_parallel_sequence_alignment.core import ScoringParams
    from cse305_parallel_sequence_alignment.models import (
        SemiGlobalBatchAligner,
    )
    params = ScoringParams(g=cfg.g, h=cfg.h, match=cfg.match,
                           mismatch=args.sg_mismatch)
    res = SemiGlobalBatchAligner(params=params).align_batch([(a, b)])[0]
    print(json.dumps({
        "score": res.score,
        "cigar": res.cigar,
        "cigar_extended": res.cigar_extended,
        "target_span": list(res.target_span),
    }))
    return 0


def cmd_overlap(args):
    cfg = config_from_args(args)
    a, b = _resolve_pair(args, cfg)
    from cse305_parallel_sequence_alignment.core import ScoringParams
    from cse305_parallel_sequence_alignment.models import (
        OverlapBatchAligner,
    )
    params = ScoringParams(g=cfg.g, h=cfg.h, match=cfg.match,
                           mismatch=args.ov_mismatch)
    res = OverlapBatchAligner(params=params).align_batch([(a, b)])[0]
    print(json.dumps({
        "score": res.score,
        "cigar": res.cigar,
        "a_span": list(res.a_span),
        "b_span": list(res.b_span),
    }))
    return 0


def cmd_batch(args):
    cfg = config_from_args(args)
    names, seqs = _load_data(cfg)
    rng = np.random.default_rng(cfg.seed)
    count = args.count
    idx1 = rng.integers(0, len(seqs) - 1, size=count)
    idx2 = rng.integers(0, len(seqs) - 1, size=count)
    pairs = []
    for k in range(count):
        s1, s2 = seqs[idx1[k]], seqs[idx2[k]]
        L = min(cfg.input_size, len(s1), len(s2))
        pairs.append((s1[:L], s2[:L]))
    from cse305_parallel_sequence_alignment.models import BatchAligner
    aligner = BatchAligner(params=cfg.params,
                           bucket_quantum=cfg.bucket_quantum,
                           max_batch=cfg.max_batch)
    t0 = time.perf_counter()
    if args.scores_only:
        scores, tables = aligner.score_batch(pairs)
        dt = time.perf_counter() - t0
        for k in range(count):
            print(f"{idx1[k]},{idx2[k]},{scores[k]:g}")
    else:
        results = aligner.align_batch(pairs)
        dt = time.perf_counter() - t0
        for res in results:
            print(res.aligned_a)
            print(res.aligned_b)
    cells = sum(len(a) * len(b) for a, b in pairs)
    print(f"# {count} pairs, {cells} cells, {dt:.3f}s, "
          f"{cells / dt / 1e9:.3f} GCUPS", file=sys.stderr)
    return 0


def cmd_experiment(args):
    cfg = config_from_args(args)
    names, seqs = _load_data(cfg)
    from cse305_parallel_sequence_alignment.harness import experiments
    which = args.which
    if which in ("input-size", "all"):
        rows = experiments.test_input_size(names, seqs, cfg)
        print(f"input_size_testing.csv: {len(rows)} rows")
    if which in ("n-cores", "all"):
        rows = experiments.test_n_cores(names, seqs, cfg)
        print(f"n_cores_testing.csv: {len(rows)} rows")
    if which in ("similarity", "all"):
        rows = experiments.test_similarity(names, seqs, cfg)
        print(f"similarity_testing.csv: {len(rows)} rows")
    return 0


def cmd_partition(args):
    cfg = config_from_args(args)
    if args.full_dataset_pair:
        # the reference's design target: align full-length dataset pairs
        # (13-97 kb genes) via the partition layer (partial.cpp:149,
        # main_alignment.cpp:353-410)
        names, seqs = _load_data(cfg)
        order = sorted(range(len(seqs)), key=lambda k: -len(seqs[k]))
        i, j = order[0], order[1]
        a, b = seqs[i], seqs[j]
        print(f"pair: {names[i].split()[0]} ({len(a)} nt) x "
              f"{names[j].split()[0]} ({len(b)} nt)", file=sys.stderr)
    else:
        a, b = _resolve_pair(args, cfg)
    from cse305_parallel_sequence_alignment.parallel.partition import (
        PartitionedAligner,
        score_chain,
    )
    from cse305_parallel_sequence_alignment.core import encode_seq
    t0 = time.perf_counter()
    aligner = PartitionedAligner(params=cfg.params, p=args.p,
                                 fill_backend=args.fill_backend)
    res = aligner.align(a, b)
    dt = time.perf_counter() - t0
    if args.full_dataset_pair:
        # don't dump ~100 kb rows; report the verified result instead
        ea, eb = encode_seq(a), encode_seq(b)
        if len(ea) > len(eb):
            ea, eb = eb, ea  # aligner's parity swap
        chain_score = score_chain(ea, eb, res.chain, cfg.params)
        cells = len(a) * len(b)
        print(json.dumps({
            "len_a": len(a), "len_b": len(b),
            "score": res.score, "chain_score": chain_score,
            "chain_len": len(res.chain),
            "aligned_rows_len": len(res.aligned_a),
            "wall_s": round(dt, 2),
            "effective_gcups": round(cells / dt / 1e9, 3),
        }))
    else:
        print(res.aligned_a)
        print(res.aligned_b)
    if args.verbose:
        print(f"score={res.score} time={dt:.2f}s", file=sys.stderr)
    return 0


def cmd_stream(args):
    cfg = config_from_args(args)
    names, seqs = _load_data(cfg)
    from cse305_parallel_sequence_alignment.harness.stream import (
        StreamRunner,
    )
    from cse305_parallel_sequence_alignment.models import BatchAligner
    from cse305_parallel_sequence_alignment.parallel.multihost import (
        init_distributed,
        process_info,
    )
    init_distributed()
    pi, pc = process_info()
    rng = np.random.default_rng(cfg.seed)
    idx1 = rng.integers(0, len(seqs) - 1, size=args.count)
    idx2 = rng.integers(0, len(seqs) - 1, size=args.count)

    def pair_iter():
        for k in range(args.count):
            s1, s2 = seqs[idx1[k]], seqs[idx2[k]]
            L = min(cfg.input_size, len(s1), len(s2))
            yield (f"{idx1[k]}x{idx2[k]}#{k}", s1[:L], s2[:L])

    aligner = BatchAligner(params=cfg.params,
                           bucket_quantum=cfg.bucket_quantum,
                           max_batch=cfg.max_batch)
    runner = StreamRunner(out_dir=args.stream_dir, aligner=aligner,
                          chunk_size=args.chunk_size,
                          process_index=pi, process_count=pc)
    man = runner.run(pair_iter())
    print(json.dumps({"pairs": man["pairs"], "cells": man["cells"],
                      "seconds": round(man["seconds"], 3)}))
    return 0


def cmd_parity(args):
    cfg = config_from_args(args)
    from cse305_parallel_sequence_alignment.harness.parity import (
        run_parity,
        sample_dataset_pairs,
    )
    _, seqs = _load_data(cfg)
    pairs = sample_dataset_pairs(seqs, args.count, args.max_len,
                                 seed=cfg.seed)
    ok, mismatches = run_parity(pairs, g=cfg.g, h=cfg.h)
    print(json.dumps({"pairs": len(pairs), "byte_equal": ok,
                      "mismatches": len(mismatches)}))
    return 0 if ok else 1


def cmd_perf(args):
    from cse305_parallel_sequence_alignment.harness.perfreport import (
        run_report,
    )
    run_report(lengths=tuple(args.lengths), batches=tuple(args.batches),
               include_longseq=not args.no_longseq)
    return 0


def cmd_longscore(args):
    """Score one (possibly huge) pair.

    Single device: the XLA row scan. Multi-device: the column-sharded
    ppermute pipeline."""
    cfg = config_from_args(args)
    a, b = _resolve_pair(args, cfg)
    from cse305_parallel_sequence_alignment.core import (
        encode_seq,
        end_table_choice,
    )
    import jax
    t0 = time.perf_counter()
    if jax.device_count() == 1:
        from cse305_parallel_sequence_alignment.ops.rowscan import (
            rowscan_score,
        )
        ea = encode_seq(a) if isinstance(a, (str, bytes)) else a
        eb = encode_seq(b) if isinstance(b, (str, bytes)) else b
        finals = np.asarray(rowscan_score(
            ea, eb, g=cfg.g, h=cfg.h, match=cfg.match,
            mismatch=cfg.mismatch))
    else:
        from cse305_parallel_sequence_alignment.parallel.longseq \
            import longseq_score
        finals = longseq_score(a, b, cfg.params, row_chunk=args.row_chunk)
    dt = time.perf_counter() - t0
    table, score = end_table_choice(
        float(finals[0]), float(finals[1]), float(finals[2]), -1, cfg.h)
    print(json.dumps({
        "score": score, "end_table": table,
        "m": len(a), "n": len(b),
        "devices": jax.device_count(),
        "seconds": round(dt, 3),
        "gcups": round(len(a) * len(b) / dt / 1e9, 3),
    }))
    return 0


def cmd_info(args):
    import jax
    print(json.dumps({
        "version": __version__,
        "backend": jax.default_backend(),
        "devices": [str(d) for d in jax.devices()],
    }, indent=2))
    return 0


def _add_pair_args(p):
    p.add_argument("--a", help="literal sequence A")
    p.add_argument("--b", help="literal sequence B")
    p.add_argument("--pair", type=int, nargs=2, default=[0, 1],
                   metavar=("I", "J"),
                   help="dataset indices when --a/--b not given")
    p.add_argument("--truncate", type=int, default=0,
                   help="truncate dataset sequences to this length")
    p.add_argument("-v", "--verbose", action="store_true")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="cse305_parallel_sequence_alignment")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("align", help="one global alignment")
    _add_pair_args(p)
    add_config_args(p)
    p.set_defaults(fn=cmd_align)

    p = sub.add_parser("local", help="one local (SW) alignment with CIGAR")
    _add_pair_args(p)
    p.add_argument("--sw-match", type=float, default=2.0)
    p.add_argument("--sw-mismatch", type=float, default=-1.0)
    add_config_args(p)
    p.set_defaults(fn=cmd_local)

    p = sub.add_parser("semiglobal",
                       help="fit query into target (free target flanks)")
    _add_pair_args(p)
    p.add_argument("--sg-mismatch", type=float, default=-1.0)
    add_config_args(p)
    p.set_defaults(fn=cmd_semiglobal)

    p = sub.add_parser("overlap",
                       help="dovetail overlap detection (free outer ends)")
    _add_pair_args(p)
    p.add_argument("--ov-mismatch", type=float, default=-1.0)
    add_config_args(p)
    p.set_defaults(fn=cmd_overlap)

    p = sub.add_parser("batch", help="score/align many dataset pairs")
    p.add_argument("--count", type=int, default=100)
    p.add_argument("--scores-only", action="store_true")
    add_config_args(p)
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("experiment", help="reference harness experiments")
    p.add_argument("which", choices=["input-size", "n-cores", "similarity",
                                     "all"])
    add_config_args(p)
    p.set_defaults(fn=cmd_experiment)

    p = sub.add_parser("partition", help="balanced-partition alignment")
    _add_pair_args(p)
    p.add_argument("--p", type=int, default=0,
                   help="number of segments (0 = auto from memory budget)")
    p.add_argument("--fill-backend", default="rowscan",
                   choices=["rowscan", "sharded"],
                   help="crossing-search fill engine")
    p.add_argument("--full-dataset-pair", action="store_true",
                   help="align the two longest dataset sequences at full "
                        "length (the reference's design workload)")
    add_config_args(p)
    p.set_defaults(fn=cmd_partition)

    p = sub.add_parser("stream",
                       help="streamed scoring with checkpoint/resume")
    p.add_argument("--count", type=int, default=1000)
    p.add_argument("--chunk-size", type=int, default=256)
    p.add_argument("--stream-dir", default="stream_out")
    add_config_args(p)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("longscore",
                       help="column-sharded score of one huge pair")
    _add_pair_args(p)
    p.add_argument("--row-chunk", type=int, default=256)
    add_config_args(p)
    p.set_defaults(fn=cmd_longscore)

    p = sub.add_parser("parity",
                       help="byte-diff vs the repaired reference binary")
    p.add_argument("--count", type=int, default=10)
    p.add_argument("--max-len", type=int, default=200)
    add_config_args(p)
    p.set_defaults(fn=cmd_parity)

    p = sub.add_parser("perf", help="GCUPS sweep report (JSON lines)")
    p.add_argument("--lengths", type=int, nargs="+", default=[512, 2048])
    p.add_argument("--batches", type=int, nargs="+", default=[64, 256])
    p.add_argument("--no-longseq", action="store_true")
    p.set_defaults(fn=cmd_perf)

    p = sub.add_parser("info", help="backend and device info")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
