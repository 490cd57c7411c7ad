"""Two-process multi-host test.

Drives parallel/multihost.py's REAL branch: two CPU-backend
subprocesses join a localhost jax.distributed coordinator, assert the
global process view, host_shard their work disjointly, and run a
cross-process psum over the global device mesh. Also pins the
fail-fast branch: a worker pointed at an unreachable coordinator
terminates on the initialization timeout instead of hanging.
"""

import json
import socket
import subprocess
import sys

WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from cse305_parallel_sequence_alignment.parallel.multihost import (
    host_shard, init_distributed, process_info)

pid = int(sys.argv[1])
ok = init_distributed(coordinator_address={coord!r}, num_processes=2,
                      process_id=pid, initialization_timeout=60)
assert ok is True
pi, pc = process_info()
assert (pi, pc) == (pid, 2), (pi, pc)
shard = list(host_shard(10))
# cross-process collective over the global mesh (DCN path)
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
devs = np.array(jax.devices())
mesh = Mesh(devs, ("data",))
n = len(devs)
x = jax.make_array_from_callback(
    (n,), NamedSharding(mesh, P("data")),
    lambda idx: np.asarray([float(pi + 1)])
)
tot = jax.jit(lambda v: jax.numpy.sum(v),
              out_shardings=NamedSharding(mesh, P()))(x)
print(json.dumps({{"pid": pid, "pc": pc, "ndev": n,
                  "shard": shard, "psum": float(tot)}}), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_two_process_init_shard_and_collective():
    import os
    coord = f"127.0.0.1:{_free_port()}"
    code = WORKER.format(repo=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), coord=coord)
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES",
                        "PROCESS_ID", "JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(pid)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env)
             for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, (out.decode()[-500:],
                                   err.decode()[-1500:])
        outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    by_pid = {o["pid"]: o for o in outs}
    assert by_pid[0]["pc"] == by_pid[1]["pc"] == 2
    # each host computed the global device count (2 procs x 2 local)
    assert by_pid[0]["ndev"] == 4
    # shards are disjoint and cover the work list
    s0, s1 = set(by_pid[0]["shard"]), set(by_pid[1]["shard"])
    assert s0.isdisjoint(s1) and s0 | s1 == set(range(10))
    # the cross-process reduction saw both processes' contributions:
    # sum over 4 shards = 2*(1) + 2*(2) = 6
    assert by_pid[0]["psum"] == by_pid[1]["psum"] == 6.0


def test_init_fail_fast_on_unreachable_coordinator():
    """A worker pointed at a dead coordinator must TERMINATE within the
    initialization timeout, never hang: jax's coordination client
    aborts the process with DEADLINE_EXCEEDED (absl fatal) — that
    termination IS the fail-fast contract this layer promises
    (SURVEY.md par.5 failure detection)."""
    import os
    import time
    code = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from cse305_parallel_sequence_alignment.parallel.multihost import (
    init_distributed)
init_distributed(coordinator_address="127.0.0.1:1",
                 num_processes=2, process_id=1,
                 initialization_timeout=5)
sys.exit(3)  # unreachable: the client aborts on deadline
""".format(repo=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES",
                        "PROCESS_ID", "JAX_PLATFORMS")}
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, timeout=120)
    took = time.monotonic() - t0
    assert out.returncode not in (0, 3), out.stderr.decode()[-500:]
    assert took < 90, f"worker hung {took:.0f}s instead of failing fast"
    assert b"DEADLINE" in out.stderr or b"Deadline" in out.stderr
