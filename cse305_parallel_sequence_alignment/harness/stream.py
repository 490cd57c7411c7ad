"""Streaming throughput engine with checkpoint/resume.

The large-scale serving mode (BASELINE config 5: millions of read-pairs
streamed across hosts): a pair stream is cut into fixed-size chunks; each
chunk is scored as one bucketed device batch; results append to a per-host
CSV; a manifest records completed chunks so an interrupted run resumes
exactly where it stopped. The reference has no checkpoint story (SURVEY.md
§5) — the pure-function engine makes chunk replay the natural recovery
granule.

Multi-host: chunks stripe across hosts (chunk_idx % process_count ==
process_index); each host writes its own shard of results; merging is a
concatenation.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

from cse305_parallel_sequence_alignment.models.batch import BatchAligner
from cse305_parallel_sequence_alignment.utils.observability import (
    gcups,
    log_event,
)


@dataclasses.dataclass
class StreamRunner:
    """Chunked scoring of a pair stream with resume.

    ``out_dir`` holds ``scores_p{process}.csv`` and
    ``manifest_p{process}.json``. ``aligner`` defaults to a BatchAligner;
    any object with ``score_batch(pairs)`` works (e.g.
    ShardedBatchAligner for multi-device hosts).
    """

    out_dir: str
    aligner: object = None
    chunk_size: int = 256
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self):
        if self.aligner is None:
            self.aligner = BatchAligner()
        os.makedirs(self.out_dir, exist_ok=True)

    @property
    def manifest_path(self):
        return os.path.join(self.out_dir,
                            f"manifest_p{self.process_index}.json")

    @property
    def scores_path(self):
        return os.path.join(self.out_dir,
                            f"scores_p{self.process_index}.csv")

    def _config_sig(self):
        """Signature of result-shaping config; a resume with a different
        signature would silently mix incompatible scores."""
        params = getattr(self.aligner, "params", None)
        return {
            "chunk_size": self.chunk_size,
            "process_count": self.process_count,
            "params": list(params.astuple()) if params else None,
        }

    def _load_manifest(self):
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                man = json.load(f)
            sig = man.get("config")
            if sig is not None and sig != self._config_sig():
                raise ValueError(
                    f"resume config mismatch: manifest {sig} vs current "
                    f"{self._config_sig()} — use a fresh out_dir")
            return man
        return {"done_chunks": [], "pairs": 0, "cells": 0, "seconds": 0.0,
                "config": self._config_sig()}

    def _save_manifest(self, man):
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(man, f)
        os.replace(tmp, self.manifest_path)  # atomic: resume-safe

    def run(self, pair_iter, total=None):
        """Process a pair stream; returns the manifest dict.

        ``pair_iter``: iterable of (id, seq_a, seq_b). Chunks already in
        the manifest are skipped (their results are on disk), so calling
        ``run`` again with the same stream resumes after an interruption.
        """
        man = self._load_manifest()
        done = set(man["done_chunks"])
        mode = "a" if os.path.exists(self.scores_path) else "w"
        with open(self.scores_path, mode) as out:
            if mode == "w":
                out.write("pair_id,score,end_table\n")
            chunk, chunk_idx = [], 0
            for item in pair_iter:
                chunk.append(item)
                if len(chunk) == self.chunk_size:
                    self._maybe_run_chunk(chunk_idx, chunk, man, done, out)
                    chunk, chunk_idx = [], chunk_idx + 1
            if chunk:
                self._maybe_run_chunk(chunk_idx, chunk, man, done, out)
        log_event("stream_done", pairs=man["pairs"], cells=man["cells"],
                  seconds=round(man["seconds"], 3),
                  gcups=round(gcups(man["cells"], man["seconds"]), 3))
        return man

    @staticmethod
    def merge(out_dir, dest="scores_merged.csv"):
        """Concatenate every host's result shard into one CSV (sorted by
        shard then order-of-arrival — deterministic given the shards)."""
        import glob

        shards = sorted(glob.glob(os.path.join(out_dir, "scores_p*.csv")))
        dest_path = os.path.join(out_dir, dest)
        n = 0
        with open(dest_path, "w") as out:
            out.write("pair_id,score,end_table\n")
            for shard in shards:
                with open(shard) as f:
                    next(f)
                    for line in f:
                        out.write(line)
                        n += 1
        return dest_path, n

    def _maybe_run_chunk(self, chunk_idx, chunk, man, done, out):
        mine = chunk_idx % self.process_count == self.process_index
        if not mine or chunk_idx in done:
            return
        t0 = time.perf_counter()
        pairs = [(a, b) for (_, a, b) in chunk]
        scores, tables = self.aligner.score_batch(pairs)
        dt = time.perf_counter() - t0
        for (pid, a, b), s, tb in zip(chunk, scores, tables):
            out.write(f"{pid},{s:g},{tb}\n")
        out.flush()
        man["done_chunks"].append(chunk_idx)
        man["pairs"] += len(chunk)
        man["cells"] += sum(len(a) * len(b) for (_, a, b) in chunk)
        man["seconds"] += dt
        self._save_manifest(man)
