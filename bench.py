"""Kernel-versus-XLA timing of the main path on one GPU.

    python bench.py [--reps N]

Times ``api.score_pairs`` and ``api.align_pairs`` end to end (host
packing, fill, walk, replay, render) with the GPU fill kernel
(ops/gpu_fill.py) and with the XLA wavefront it replaces, on seeded
homologous pairs:

- score: 256 pairs of ~2 kb and 16,384 pairs of ~256 bp;
- align: 256 pairs of ~2 kb, reference scoring (match 1, mismatch 0,
  h 2, g 1).

Each measurement runs the two backends in turns (kernel, XLA, XLA,
kernel, ...) after a warm-up call that compiles, and reports every
run's seconds and the median. Output is one JSON line naming the
device, the card's name and power limit. Without a GPU the script
exits non-zero: it never measures on another platform.

One process drives the card. Cells of a real benchmark (one per
deployment, with traced per-layer time) are ROADMAP item A1.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def card():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ab(fn_kernel, fn_xla, reps):
    """Warm both, then time them in alternating order; returns
    {"kernel": [...], "xla": [...]} seconds and the two results."""
    out_k, out_x = fn_kernel(), fn_xla()
    times = {"kernel": [], "xla": []}
    for r in range(reps):
        order = (("kernel", fn_kernel), ("xla", fn_xla))
        if r % 2:
            order = order[::-1]
        for name, fn in order:
            t = time.perf_counter()
            fn()
            times[name].append(time.perf_counter() - t)
    return times, out_k, out_x


def summary(times, work, unit):
    row = {}
    for name, ts in times.items():
        med = statistics.median(ts)
        row[name] = {"seconds": ts, "median_s": med,
                     unit: work / med}
    row["kernel_speedup"] = row["xla"]["median_s"] / \
        row["kernel"]["median_s"]
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=4)
    args = parser.parse_args(argv)

    import jax
    import numpy as np

    from cse305_parallel_sequence_alignment import align_pairs, score_pairs
    from cse305_parallel_sequence_alignment.utils.synth import (
        homologous_pairs,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures on a GPU; JAX found {dev.platform!r}")
    line = {"platform": dev.platform, "device_kind": dev.device_kind,
            "count": len(jax.devices()), "card": card()}

    for count, length in ((256, 2000), (16384, 256)):
        pairs = homologous_pairs(count, length, seed=1)
        cells = float(sum(len(a) * len(b) for a, b in pairs))
        times, (sk, _), (sx, _) = ab(
            lambda: score_pairs(pairs, backend="kernel"),
            lambda: score_pairs(pairs, backend="wavefront"), args.reps)
        if not np.array_equal(sk, sx):
            sys.exit(f"score mismatch at {count} x {length}")
        row = summary(times, cells / 1e9, "gcups")
        line[f"score_{count}x{length}"] = row
        print(f"score {count}x{length}: {json.dumps(row)}", flush=True)

    pairs = homologous_pairs(256, 2000, seed=2)
    times, rk, rx = ab(lambda: align_pairs(pairs, backend="kernel"),
                       lambda: align_pairs(pairs, backend="wavefront"),
                       args.reps)
    for x, y in zip(rk, rx):
        if (x.score, list(x.chain), x.aligned_a, x.aligned_b) != \
                (y.score, list(y.chain), y.aligned_a, y.aligned_b):
            sys.exit("alignment mismatch between kernel and XLA paths")
    row = summary(times, len(pairs), "pairs_per_s")
    line["align_256x2000"] = row
    print(f"align 256x2000: {json.dumps(row)}", flush=True)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
