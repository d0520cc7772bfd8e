"""Regression tests for __graft_entry__'s multi-device dry run.

dryrun_multichip must build its virtual CPU mesh whatever backend the
process would pick by default (a GPU machine's, say).  These tests run the
entry point in a subprocess with no helpful env vars, so the CPU-forcing
must be self-contained.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scrubbed_env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.slow
def test_dryrun_multichip_forces_cpu_mesh():
    # dryrun_multichip(N) may run where another platform is the default;
    # the function must force a virtual CPU mesh itself.
    code = (
        "from __graft_entry__ import dryrun_multichip\n"
        "dryrun_multichip(8)\n"
        "import jax\n"
        "assert jax.devices()[0].platform == 'cpu', jax.devices()\n"
        "assert len(jax.devices()) >= 8\n"
        "print('DRYRUN_OK')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=_scrubbed_env(),
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    assert "DRYRUN_OK" in r.stdout


@pytest.mark.slow
def test_dryrun_multichip_after_foreign_backend_init():
    # worst case: something already initialized a (possibly non-CPU) backend
    # in-process before dryrun is called; it must recover by clearing
    # backends and reconfiguring.
    code = (
        "import jax\n"
        "jax.devices()\n"  # initialize whatever backend the env picks
        "from __graft_entry__ import dryrun_multichip\n"
        "dryrun_multichip(8)\n"
        "assert jax.devices()[0].platform == 'cpu'\n"
        "assert len(jax.devices()) >= 8\n"
        "print('DRYRUN_OK')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=_scrubbed_env(),
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    assert "DRYRUN_OK" in r.stdout
