"""The main path imports without the optional neural-network libraries."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("blocked", [("flax",), ("orbax",), ("flax", "orbax")])
def test_main_path_imports_without(blocked):
    code = (
        "import sys\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in blocked)
        + "import gym_po_tpu, gym_po_tpu.agents, gym_po_tpu.vector, "
        "gym_po_tpu.ops, gym_po_tpu.parallel, gym_po_tpu.utils.checkpoint\n"
        "env = gym_po_tpu.make('Taxi-v4')\n"
        "assert 'flax' not in [m.split('.')[0] for m in sys.modules "
        "if sys.modules[m] is not None]\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
