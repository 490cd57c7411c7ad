"""Many-pairs data parallelism over a device mesh (reference P6).

The reference's throughput strategy is a pool of std::threads each running
a whole alignment (testing.cpp:112-158). Here the bucketed batch is
sharded over the ``data`` mesh axis with ``shard_map``; every device runs
the same diagonal-sweep fill on its shard. There is no cross-device
communication in this mode — scores come back device-sharded and are
gathered on host.

Works on any backend: the mapped function is the pure-JAX wavefront
step.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from cse305_parallel_sequence_alignment.models.batch import BatchAligner
from cse305_parallel_sequence_alignment.models.local import (
    LocalBatchAligner,
)
from cse305_parallel_sequence_alignment.ops.wavefront import (
    _wavefront_single,
)
from cse305_parallel_sequence_alignment.parallel.mesh import (
    make_data_mesh,
)


@functools.partial(
    jax.jit,
    static_argnames=("g", "h", "match", "mismatch", "start_type",
                     "num_devices"))
def _sharded_score(a_enc, b_enc, len_a, len_b, g, h, match, mismatch,
                   start_type, num_devices):
    mesh = make_data_mesh(num_devices)
    fn = functools.partial(
        _wavefront_single, g=g, h=h, match=match, mismatch=mismatch,
        start_type=start_type, want_dirs=False)

    def local(a, b, la, lb):
        return jax.vmap(fn)(a, b, la, lb)

    # check_vma off: the scan carry starts replicated (boundary rows) and
    # becomes device-varying only through the sharded sequence inputs; no
    # collectives exist in this mode, so the check adds nothing.
    mapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data")),
        out_specs=P("data"), check_vma=False)
    return mapped(a_enc, b_enc, len_a, len_b)


@functools.partial(
    jax.jit,
    static_argnames=("g", "h", "match", "mismatch", "start_type",
                     "num_devices"))
def _sharded_dirs(a_enc, b_enc, len_a, len_b, g, h, match, mismatch,
                  start_type, num_devices):
    """Data-sharded dirs-emitting fill: every device fills its shard's
    direction matrices; finals and dirs come back batch-sharded."""
    mesh = make_data_mesh(num_devices)
    fn = functools.partial(
        _wavefront_single, g=g, h=h, match=match, mismatch=mismatch,
        start_type=start_type, want_dirs=True)

    def local(a, b, la, lb):
        return jax.vmap(fn)(a, b, la, lb)

    mapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False)
    return mapped(a_enc, b_enc, len_a, len_b)


@functools.partial(
    jax.jit,
    static_argnames=("g", "h", "match", "mismatch", "num_devices"))
def _sharded_sw_score(a_enc, b_enc, len_a, len_b, g, h, match, mismatch,
                      num_devices):
    """Data-sharded local (SW) score fill."""
    from cse305_parallel_sequence_alignment.ops.local import _sw_single

    mesh = make_data_mesh(num_devices)
    fn = functools.partial(
        _sw_single, g=g, h=h, match=match, mismatch=mismatch,
        want_dirs=False)

    def local(a, b, la, lb):
        return jax.vmap(fn)(a, b, la, lb)

    mapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data")),
        out_specs=P("data"), check_vma=False)
    return mapped(a_enc, b_enc, len_a, len_b)


@dataclasses.dataclass
class ShardedBatchAligner(BatchAligner):
    """BatchAligner whose fill launches (score and dirs) are sharded
    over the data mesh; traceback stays on host (native batch walk)."""

    num_devices: int = 0  # 0 = all

    def __post_init__(self):
        if self.num_devices <= 0:
            self.num_devices = jax.device_count()

    def _use_kernel(self):
        return False  # the sharded fills are the XLA wavefront

    def _pad_and_put(self, a, b, la, lb):
        nd = self.num_devices
        B = a.shape[0]
        Bp = -(-B // nd) * nd
        if Bp != B:
            pad = Bp - B
            a = np.concatenate([a, np.repeat(a[-1:], pad, 0)], 0)
            b = np.concatenate([b, np.repeat(b[-1:], pad, 0)], 0)
            la = np.concatenate([la, np.repeat(la[-1:], pad, 0)], 0)
            lb = np.concatenate([lb, np.repeat(lb[-1:], pad, 0)], 0)
        mesh = make_data_mesh(nd)
        sharding = NamedSharding(mesh, P("data"))
        return [jax.device_put(jnp.asarray(x), sharding)
                for x in (a, b, la, lb)], B

    def _finals(self, a, b, la, lb):
        dev, B = self._pad_and_put(a, b, la, lb)
        g, h, match, mismatch = self.params.astuple()
        out = _sharded_score(*dev, g=g, h=h, match=match,
                             mismatch=mismatch, start_type=self.start_type,
                             num_devices=self.num_devices)
        return np.asarray(out)[:B]

    def _dirs(self, a, b, la, lb):
        dev, B = self._pad_and_put(a, b, la, lb)
        g, h, match, mismatch = self.params.astuple()
        finals, dirs = _sharded_dirs(
            *dev, g=g, h=h, match=match, mismatch=mismatch,
            start_type=self.start_type, num_devices=self.num_devices)
        return np.asarray(finals)[:B], np.asarray(dirs)[:B]


@dataclasses.dataclass
class ShardedLocalBatchAligner(LocalBatchAligner):
    """LocalBatchAligner whose score fill is sharded over the data mesh
    (the high-throughput SW filtering mode; traceback of survivors runs
    through the unsharded dirs path)."""

    num_devices: int = 0  # 0 = all

    def __post_init__(self):
        if self.num_devices <= 0:
            self.num_devices = jax.device_count()

    def _best(self, a, b, la, lb):
        nd = self.num_devices
        B = a.shape[0]
        Bp = -(-B // nd) * nd
        if Bp != B:
            pad = Bp - B
            a = np.concatenate([a, np.repeat(a[-1:], pad, 0)], 0)
            b = np.concatenate([b, np.repeat(b[-1:], pad, 0)], 0)
            la = np.concatenate([la, np.repeat(la[-1:], pad, 0)], 0)
            lb = np.concatenate([lb, np.repeat(lb[-1:], pad, 0)], 0)
        mesh = make_data_mesh(nd)
        sharding = NamedSharding(mesh, P("data"))
        dev = [jax.device_put(jnp.asarray(x), sharding)
               for x in (a, b, la, lb)]
        g, h, match, mismatch = self.params.astuple()
        out = _sharded_sw_score(*dev, g=g, h=h, match=match,
                                mismatch=mismatch, num_devices=nd)
        return np.asarray(out)[:B]
