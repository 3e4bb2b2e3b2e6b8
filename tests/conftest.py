"""Shared fixtures: RNG, the 8-fake-device subprocess launcher (one
implementation instead of the copy in every executor-family test file),
and parameterized fault plans for the client-fleet suite."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc (skipped without one)"
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def run_on_fake_devices(script, *, devices=8, timeout=600):
    """Run ``script`` in a fresh interpreter with ``devices`` fake CPU
    devices and return its LAST stdout line parsed as JSON.

    Mesh/multipod placements need more than one XLA device, which a
    normal CPU test process doesn't have — and the device-count flag
    must be set before jax initializes, hence the subprocess.  The
    script's contract: print exactly one JSON object as its final line.
    """
    from repro import api

    # repro may be a namespace package (no __file__) — anchor on api
    src = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(api.__file__)))
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devices}"
    )
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, env=env, timeout=timeout,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="session")
def fake_devices():
    """The shared launcher as a fixture (tests/test_executors,
    test_serve, test_trace, …)."""
    return run_on_fake_devices


# the fault-plan grid every parametrized fleet test runs over: pure
# dropout, pure stragglers, a quorum gate, and the combined plan
FAULT_PLAN_SPECS = [
    pytest.param({"dropout_p": 0.3}, id="dropout"),
    pytest.param({"straggler": 2}, id="straggler"),
    pytest.param({"dropout_p": 0.4, "quorum": 2}, id="quorum"),
    pytest.param(
        {"dropout_p": 0.3, "straggler": 1, "quorum": 2}, id="combined"
    ),
]


@pytest.fixture(params=FAULT_PLAN_SPECS)
def fault_plan(request):
    """A fresh seeded FaultPlan per parametrization (seed fixed so every
    consumer of the fixture sees the same schedule)."""
    from repro.api.faults import FaultPlan

    return FaultPlan(seed=11, **request.param)
