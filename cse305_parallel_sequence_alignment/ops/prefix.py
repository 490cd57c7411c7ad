"""Parallel prefix primitives (reference P3), the XLA way.

The reference implements block-scan + pointer-jumping prefix sum/max with
std::thread forks (main_alignment.cpp:81-156, subproblem_alignment.cpp:29-103).
On the device the same PRAM algorithm is one fused `lax.associative_scan`,
which XLA lowers to a logarithmic in-register scan — no thread forks, no
memory round-trips.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def prefix_max(x, axis: int = -1):
    """Inclusive running maximum along ``axis``.

    Device equivalent of the reference's ``ParallelPrefixMax``
    (subproblem_alignment.cpp:29-103): the primitive that linearises the
    gap-table recurrence (P2).
    """
    return jax.lax.associative_scan(jnp.maximum, x, axis=axis)


def prefix_sum(x, axis: int = -1):
    """Inclusive running sum along ``axis``.

    Device equivalent of the reference's ``ParallelPrefix``
    (main_alignment.cpp:81-156). VESTIGIAL BY DESIGN: the reference
    prefix-sums per-subproblem omega work estimates to deal processors
    (C6); this framework's load balance comes from static length
    bucketing + dirs-budget chunking (models/batch.py), which needs no
    runtime scan. Kept as the documented C5a counterpart, covered by
    tests/test_prefix.py, for users porting omega-style schedulers.
    """
    return jax.lax.associative_scan(jnp.add, x, axis=axis)
