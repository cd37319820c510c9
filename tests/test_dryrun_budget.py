"""Time-budget guard for the driver's multichip dryrun artifact.

The round-3 engine rewrite silently pushed ``dryrun_multichip(8)``'s
XLA:CPU compile to ~20 minutes and the multichip dryrun timed out —
nothing in-repo exercised it under a clock.  This test runs
the REAL entry point (``__graft_entry__.dryrun_multichip``) in a fresh
subprocess on the 8-device virtual CPU mesh under a hard timeout, so a
trace-size regression in the ant physics (or any dryrun stage) fails the
suite instead of the round artifact.

Budget: the dryrun measures ~77 s on this machine with the array constraint
pipeline (physics/contact.constraint_rows_array); 300 s gives ~4x headroom
for loaded machines while still catching a return to the scalar pipeline's
~20-minute compile.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import sys, jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
import __graft_entry__
__graft_entry__.dryrun_multichip(8)
print("DRYRUN_OK")
""".format(repo=REPO)


@pytest.mark.slow
def test_dryrun_multichip_within_budget():
    env = dict(os.environ)
    # mirror the driver's environment: 8 virtual devices, but NOT the test
    # suite's SSE4_2 codegen pin (the driver compiles at full ISA)
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "device_count" not in f and "max_isa" not in f]
    flags.append("--xla_force_host_platform_device_count=8")
    env["XLA_FLAGS"] = " ".join(flags)
    env.pop("JAX_PLATFORMS", None)
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _CODE], env=env, timeout=300,
            capture_output=True, text=True,
        )
    except subprocess.TimeoutExpired as e:
        pytest.fail(
            "dryrun_multichip(8) blew the 300 s budget. "
            f"stderr tail: {(e.stderr or '')[-2000:]}"
        )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "DRYRUN_OK" in proc.stdout
