"""Decompose the ant engine's cost by stage across batch sizes.

On the previous accelerator the engine's throughput fell past B=4096 (on
the H100 it does not: PERF.md, the ant batch curve).  This probe times the
pipeline STAGES at several batch sizes in one process, so a stage whose
per-env cost grows with B is identified by measurement:

  smooth   — unconstrained dynamics only (kinematics+CRBA+bias+chol),
             scanned 120x to match one env-step's substep count;
  solve1   — full constrained forward, euler frame_skip=15, iters=1;
  solve8   — same with iters=8 (the production solver depth).

The marginal solver cost is (solve8 - solve1)/7 per iteration; if smooth
scales with B but solveN does not, a cliff lives in the Newton loop's
working set.

    python benchmarks/cliff_probe.py [--batches 4096,16384] [--steps 4]
"""

from __future__ import annotations

import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")
from gym_po_tpu.physics import make_ant_model, TAG_WALLS
from gym_po_tpu.physics.dynamics import smooth_forward_s
from gym_po_tpu.physics.engine import PhysicsState, step
from gym_po_tpu.utils import enable_compilation_cache

enable_compilation_cache()

STAND = np.array(
    [0.0, 0.0, 0.55, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, -1.0, 0.0, -1.0,
     0.0, 1.0], np.float32,
)


def timed(run, args, n_env_steps, windows=5):
    t0 = time.perf_counter()
    float(run(*args))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        float(run(*args))
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    return compile_s, med, n_env_steps / med


def bench_api(batches, steps):
    """Measure the PUBLIC chunked API (vector.chunked_rollout) on the real
    AntTagPhysics-v0 env — monolithic vs dispatch_batch=4096 — so the
    remedy's BASELINE row attaches to the surface users actually call."""
    import gym_po_tpu as gpt
    from gym_po_tpu.vector import chunked_rollout, rollout

    env = gpt.make("AntTagPhysics-v0", integrator="euler")
    for b in batches:
        obs, state = jax.jit(
            lambda k: env.reset_vec(k, b))(jax.random.PRNGKey(0))
        jax.block_until_ready(obs)
        for label, fn in (
            ("monolithic", lambda k, init: rollout(
                env, k, None, b, steps, init=init)),
            ("chunked4096", lambda k, init: chunked_rollout(
                env, k, None, b, steps, dispatch_batch=4096, init=init)),
        ):
            key = jax.random.PRNGKey(1)
            traj, fin = fn(key, (obs, state))          # compile + warm
            _ = float(jnp.sum(traj.reward)) + float(jnp.sum(fin[0]))
            times = []
            for w in range(5):
                t0 = time.perf_counter()
                traj, fin = fn(jax.random.fold_in(key, w), (obs, state))
                # scalar fetch through the data dependency = honest sync
                _ = float(jnp.sum(traj.reward)) + float(jnp.sum(fin[0]))
                times.append(time.perf_counter() - t0)
            med = float(np.median(times))
            print(f"B={b:6d} api/{label:11s}: median={med*1e3:8.1f}ms "
                  f"env-steps/s={b*steps/med:12,.0f}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="4096,16384")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--frame-skip", type=int, default=15)
    ap.add_argument("--api", action="store_true",
                    help="bench the public vector.chunked_rollout API on "
                    "AntTagPhysics-v0 (euler) instead of the bare engine "
                    "stages")
    args = ap.parse_args()
    if args.api:
        bench_api([int(x) for x in args.batches.split(",")], args.steps)
        return

    model = make_ant_model(TAG_WALLS)
    print(f"device={jax.devices()[0].platform}")

    for b in (int(x) for x in args.batches.split(",")):
        key = jax.random.PRNGKey(0)
        kq, kv, ka = jax.random.split(key, 3)
        qpos = jnp.asarray(STAND)[None] + 0.01 * jax.random.normal(
            kq, (b, 15), jnp.float32)
        qvel = 0.1 * jax.random.normal(kv, (b, 14), jnp.float32)
        warm = jnp.zeros((b, 14), jnp.float32)
        ctrl = jax.random.uniform(ka, (b, 8), jnp.float32, -1.0, 1.0)

        # ---- smooth-only, scanned fs*steps times ----
        def smooth_one(q, v, c):
            _, _, qacc, _ = smooth_forward_s(model, q, v, c)
            return jnp.stack(qacc)

        smooth_v = jax.vmap(smooth_one)

        @jax.jit
        def run_smooth(qpos, qvel, ctrl):
            def body(carry, _):
                v = carry
                a = smooth_v(qpos, v, ctrl)
                return v + model.dt * a, ()
            v, _ = jax.lax.scan(body, qvel, None,
                                length=args.frame_skip * args.steps)
            return jnp.sum(v)

        c_s, med, sps = timed(run_smooth, (qpos, qvel, ctrl),
                              b * args.steps)
        print(f"B={b:6d} smooth : compile={c_s:7.1f}s "
              f"median={med*1e3:8.1f}ms env-steps/s={sps:12,.0f}",
              flush=True)

        # ---- full constrained forward at iters 1 and 8 ----
        for iters in (1, 8):
            one = jax.vmap(lambda q, v, w, c: step(
                model, PhysicsState(q, v, w), c,
                frame_skip=args.frame_skip, iters=iters,
                integrator="euler"))

            @jax.jit
            def run(qpos, qvel, warm, ctrl):
                def body(carry, _):
                    s = one(*carry, ctrl)
                    return (s.qpos, s.qvel, s.warm), ()
                (q, v, _), _ = jax.lax.scan(
                    body, (qpos, qvel, warm), None, length=args.steps)
                return jnp.sum(q) + jnp.sum(v)

            c_s, med, sps = timed(run, (qpos, qvel, warm, ctrl),
                                  b * args.steps)
            print(f"B={b:6d} solve{iters}: compile={c_s:7.1f}s "
                  f"median={med*1e3:8.1f}ms env-steps/s={sps:12,.0f}",
                  flush=True)

        # ---- sequential host dispatches of 4096-wide executables
        # (vector.chunked) against the monolithic program ----
        C = 4096
        if b > C:
            one_c = jax.vmap(lambda q, v, w, c: step(
                model, PhysicsState(q, v, w), c,
                frame_skip=args.frame_skip, iters=8, integrator="euler"))

            @jax.jit
            def run_c(qpos, qvel, warm, ctrl):
                def body(carry, _):
                    s = one_c(*carry, ctrl)
                    return (s.qpos, s.qvel, s.warm), ()
                (q, v, _), _ = jax.lax.scan(
                    body, (qpos, qvel, warm), None, length=args.steps)
                return jnp.sum(q) + jnp.sum(v)

            parts = [
                (qpos[i * C:(i + 1) * C], qvel[i * C:(i + 1) * C],
                 warm[i * C:(i + 1) * C], ctrl[i * C:(i + 1) * C])
                for i in range(b // C)
            ]
            _ = sum(float(run_c(*p)) for p in parts)   # compile + warm
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                outs = [run_c(*p) for p in parts]      # dispatches pipeline
                _ = sum(float(o) for o in outs)
                times.append(time.perf_counter() - t0)
            med = float(np.median(times))
            print(f"B={b:6d} hostloop{C}: "
                  f"median={med*1e3:8.1f}ms "
                  f"env-steps/s={b*args.steps/med:12,.0f}", flush=True)


if __name__ == "__main__":
    main()
