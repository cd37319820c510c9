"""Micro-benchmark of the rigid-body ant engine (physics.engine.step).

Measures env-steps/s (one env step = frame_skip integrator substeps) for a
batch of independent ants under vmap+jit, using the repo timing rules
(value-fetch sync through the data dependency, median of windows — see
CLAUDE.md).  Run:

    python benchmarks/physics_bench.py [--batches 256,1024,4096] \
        [--integrator rk4|euler] [--iters 8] [--steps 8]
"""

from __future__ import annotations

import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")  # repo root
from gym_po_tpu.physics import make_ant_model, TAG_WALLS
from gym_po_tpu.physics.engine import PhysicsState, step
from gym_po_tpu.utils import enable_compilation_cache

enable_compilation_cache()

STAND = np.array(
    [0.0, 0.0, 0.55, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, -1.0, 0.0, -1.0,
     0.0, 1.0], np.float32,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="256,1024,4096")
    ap.add_argument("--integrator", default="rk4")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--frame-skip", type=int, default=15)
    ap.add_argument("--steps", type=int, default=8,
                    help="env steps per timing window (scan length)")
    ap.add_argument("--windows", type=int, default=5)
    args = ap.parse_args()

    model = make_ant_model(TAG_WALLS)
    print(f"device={jax.devices()[0].platform} integrator={args.integrator} "
          f"iters={args.iters} frame_skip={args.frame_skip}")

    for b in (int(x) for x in args.batches.split(",")):
        key = jax.random.PRNGKey(0)
        kq, kv, ka = jax.random.split(key, 3)
        qpos = jnp.asarray(STAND)[None] + 0.01 * jax.random.normal(
            kq, (b, 15), jnp.float32)
        qvel = 0.1 * jax.random.normal(kv, (b, 14), jnp.float32)
        warm = jnp.zeros((b, 14), jnp.float32)
        ctrl = jax.random.uniform(ka, (b, 8), jnp.float32, -1.0, 1.0)

        one = jax.vmap(lambda q, v, w, c: step(
            model, PhysicsState(q, v, w), c, frame_skip=args.frame_skip,
            iters=args.iters, integrator=args.integrator))

        @jax.jit
        def run(qpos, qvel, warm, ctrl):
            def body(carry, _):
                q, v, w = carry
                s = one(q, v, w, ctrl)
                return (s.qpos, s.qvel, s.warm), ()

            (q, v, w), _ = jax.lax.scan(
                body, (qpos, qvel, warm), None, length=args.steps)
            return jnp.sum(q) + jnp.sum(v)

        t0 = time.perf_counter()
        float(run(qpos, qvel, warm, ctrl))  # compile + first window
        compile_s = time.perf_counter() - t0

        times = []
        for _ in range(args.windows):
            t0 = time.perf_counter()
            float(run(qpos, qvel, warm, ctrl))  # value fetch = real sync
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        sps = b * args.steps / med
        print(f"B={b:6d}  compile+1st={compile_s:7.2f}s  "
              f"median_window={med * 1e3:8.2f}ms  env-steps/s={sps:12,.0f}")


if __name__ == "__main__":
    main()
