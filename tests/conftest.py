"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Must set XLA flags before jax initializes so sharded/multi-device code
paths (parallel/*) are testable without GPUs, mirroring how the same
shard_map programs run over NVLink on a multi-GPU host.
"""

import os

# JAX_PLATFORMS=cuda keeps the card for the ``gpu``-marked tests
# (``python -m pytest -m gpu tests/`` on a GPU host); anything else runs
# the suite on the CPU mesh.
ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
if ON_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if ON_CPU:
    jax.config.update("jax_platforms", "cpu")

import json
import pathlib

import pytest

GOLDEN = pathlib.Path(__file__).parent / "golden" / "cases.jsonl"


def load_golden(kind=None):
    records = [json.loads(line) for line in GOLDEN.read_text().splitlines()]
    if kind is not None:
        records = [r for r in records if r["kind"] == kind]
    return records


@pytest.fixture(scope="session")
def golden_pipeline():
    return load_golden("pipeline")


@pytest.fixture(scope="session")
def golden_subproblem():
    return load_golden("subproblem")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` run only where JAX's device is a GPU (the
    kernel compiled for the card, which has no CPU form); elsewhere
    they skip. Decided here, at run time, never at import."""
    if request.node.get_closest_marker("gpu") and \
            jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: runs on the card via chip_smoke.py")


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    The full suite compiles many hundreds of CPU programs in one
    process; past ~80% the XLA CPU backend segfaults INSIDE a compile
    (reproduced three times at the same test, with and without the
    persistent cache, on an idle machine — accumulated JIT state, not
    this repo's code). Dropping executables at module boundaries keeps
    the process under the trigger threshold at the cost of some
    cross-module recompiles."""
    yield
    jax.clear_caches()
