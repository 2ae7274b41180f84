"""Test configuration: run all tests on a virtual 8-device CPU mesh.

Multi-chip sharding is validated without TPU hardware by exposing 8 CPU
devices (the analogue of the reference's "run.pl runs cluster jobs as local
background processes", utils/run.pl:7-29).  jax.config is used rather than
env vars because pytest plugins may import jax before this file runs.
"""

import os

# belt and braces for subprocesses spawned from tests
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end tests")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
