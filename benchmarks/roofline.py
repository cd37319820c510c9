"""MFU / roofline accounting for the ant engine.

Counts the FLOPs each program ACTUALLY executes — via the trip-count-aware
jaxpr walker in ``gym_po_tpu.utils.flops`` (XLA's own cost_analysis counts
loop bodies once and under-counts the engine ~200x) — then measures
env-steps/s on the attached device and reports achieved FLOP/s against the
device's published peak (:data:`PEAKS`, keyed by ``device_kind``).  The
engine issues f32 elementwise work, so the bound is the f32 rate outside
the tensor cores; a device missing from the table is an error.

    python benchmarks/roofline.py [--batch 4096] [--steps 4]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")
from gym_po_tpu.physics import TAG_WALLS, make_ant_model  # noqa: E402
from gym_po_tpu.physics.engine import PhysicsState, step  # noqa: E402
from gym_po_tpu.utils import enable_compilation_cache  # noqa: E402
from gym_po_tpu.utils.flops import flops_of  # noqa: E402

# Published dense peaks per device_kind: f32 FLOP/s outside the tensor cores
# and HBM bytes/s.  Source: NVIDIA H100 data sheet, SXM part, at the full
# 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes": 3.35e12},
}
STAND = np.array(
    [0.0, 0.0, 0.55, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, -1.0, 0.0, -1.0,
     0.0, 1.0], np.float32,
)


def measure_engine(batch, steps, integrator, iters, windows=5):
    model = make_ant_model(TAG_WALLS)
    kq, kv, ka = jax.random.split(jax.random.PRNGKey(0), 3)
    qpos = jnp.asarray(STAND)[None] + 0.01 * jax.random.normal(
        kq, (batch, 15), jnp.float32)
    qvel = 0.1 * jax.random.normal(kv, (batch, 14), jnp.float32)
    warm = jnp.zeros((batch, 14), jnp.float32)
    ctrl = jax.random.uniform(ka, (batch, 8), jnp.float32, -1.0, 1.0)

    one = jax.vmap(lambda q, v, w, c: step(
        model, PhysicsState(q, v, w), c, frame_skip=15, iters=iters,
        integrator=integrator))

    @jax.jit
    def run(qpos, qvel, warm, ctrl):
        def body(carry, _):
            s = one(*carry, ctrl)
            return (s.qpos, s.qvel, s.warm), ()
        (q, v, _), _ = jax.lax.scan(body, (qpos, qvel, warm), None,
                                    length=steps)
        return jnp.sum(q) + jnp.sum(v)

    jax.block_until_ready(run(qpos, qvel, warm, ctrl))  # compile + warm
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        jax.block_until_ready(run(qpos, qvel, warm, ctrl))
        times.append(time.perf_counter() - t0)
    return batch * steps / float(np.median(times))


def peak_for(device) -> dict:
    """The :data:`PEAKS` row of ``device``; unknown devices raise."""
    try:
        return PEAKS[device.device_kind]
    except KeyError:
        raise KeyError(
            f"no published peak for device_kind {device.device_kind!r}; "
            "add it to PEAKS with its source") from None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--skip-measure", action="store_true",
                    help="FLOP counts only (no device timing)")
    args = ap.parse_args()
    peak = None if args.skip_measure else peak_for(jax.devices()[0])
    if peak is not None:
        enable_compilation_cache()

    model = make_ant_model(TAG_WALLS)
    q = jnp.asarray(STAND)
    v = jnp.zeros(14)
    w = jnp.zeros(14)
    c = jnp.zeros(8)

    for integ, iters in (("rk4", 8), ("euler", 8), ("euler", 1)):
        fl = flops_of(
            lambda q, v, w, c: step(model, PhysicsState(q, v, w), c,
                                    frame_skip=15, iters=iters,
                                    integrator=integ), q, v, w, c)
        rec = {
            "program": f"ant engine {integ} fs=15 iters={iters} "
                       f"(scalar pipeline)",
            "flops_per_env_step": round(fl),
        }
        if not args.skip_measure:
            sps = measure_engine(args.batch, args.steps, integ, iters)
            rec.update({
                "batch": args.batch,
                "env_steps_per_s": round(sps),
                "device_kind": jax.devices()[0].device_kind,
                "achieved_tflops": round(fl * sps / 1e12, 3),
                "f32_peak_share_pct": round(100 * fl * sps
                                            / peak["f32_flops"], 2),
            })
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
