#!/usr/bin/env python3
"""Smoke test: the main path of gym-po-tpu on one NVIDIA GPU.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # the four-card phase only
    python chip_smoke.py --rehearse    # tiny shapes on the CPU; prints no result

Each phase prints one line with its numbers; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases (one card):
  1. device     the card as nvidia-smi reports it (name, power limit);
  2. rollouts   ``vector.rollout`` of every grid family of
                benchmarks/suite.py at B=65536; the first 32 steps equal the
                same jitted code on the CPU backend (integer families exactly;
                float families within 1e-5, except at most 0.1% of envs that
                a last-bit difference sends across a cell boundary);
  3. taxi       the fused taxi rollout: the Triton kernel against its XLA
                twin (bit-identical in tape mode at B=1M) and both against
                ``vector.rollout`` + reward sum, steps/s at B=1M and 64k;
  4. trainers   every fused tabular trainer, one tape-mode chunk on the card
                against the same chunk on the CPU, exploring with
                probability 1 so the tape fixes every action (Q-tables
                within 1e-6 of the table's scale: scatter-add order differs;
                see phase_trainers);
  5. ppo        Anakin PPO at B=32768, T=128 and GRU-PPO, a few updates:
                compile and update times, finite losses;
  6. ant        AntTagPhysics-v0 at the reference physics (rk4, frame_skip
                15, 8 solver iterations), B=4096: env steps and one full PPO
                update; a 10-step trajectory of 64 envs against the CPU
                (3/4 of the envs within 1e-4: the dynamics are chaotic);
  7. tests      the ``gpu``-marked tests, in this process.

With ``--four-cards``: Anakin PPO sharded over 4 cards against the same
global batch on one card (the per-card updates under ``jax.vmap`` with the
same gradient ``pmean``), and the data-parallel tabular trainer, whose
tables must be identical on every card after the ``pmean``.

Without a GPU the script exits non-zero and prints no result.  It runs one
process; nvidia-smi is the only child, and it exits before any phase runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

FULL = dict(
    rollout_B=65536, rollout_T=32,
    taxi_B=1 << 20, taxi_small_B=65536, taxi_K=256, taxi_tape_K=16,
    trainer_B=8192, trainer_K=64, trainer_K_choice=8,
    ppo_B=32768, ppo_T=128, ppo_updates=3,
    ant_B=4096, ant_T=4, ant_ppo_T=16, ant_cmp_B=64, ant_cmp_T=10,
    four_B=32768, four_T=128, four_updates=4, four_trainer_B=4 * 8192,
    four_trainer_K=256,
)
TINY = dict(
    rollout_B=256, rollout_T=8,
    taxi_B=2048, taxi_small_B=1024, taxi_K=8, taxi_tape_K=4,
    trainer_B=256, trainer_K=8, trainer_K_choice=4,
    ppo_B=256, ppo_T=8, ppo_updates=2,
    ant_B=4, ant_T=1, ant_ppo_T=2, ant_cmp_B=2, ant_cmp_T=1,
    four_B=64, four_T=8, four_updates=2, four_trainer_B=4 * 256,
    four_trainer_K=8,
)
# float tolerance of GPU-vs-CPU comparisons (f32 transcendentals and FMA
# contraction differ in the last bits between the two backends)
ROLLOUT_ATOL = 1e-5
# f32-state families: a last-bit difference can move a position across a
# cell boundary, after which that env's trajectory legitimately diverges;
# at most this fraction of envs may do so over the compared steps
ROLLOUT_MAX_DIVERGED = 1e-3
QTABLE_RTOL = 1e-6
ANT_QPOS_ATOL = 1e-4  # on 3/4 of the envs: see phase_ant
FOUR_CARD_RTOL = 1e-4
# the ant phase runs the array constraint pipeline: the default scalar
# pipeline's cold compile on the H100 is 506 s, past this script's budget
# with the rest of the phases (PERF.md)
ANT_PIPELINE = "array"


def say(phase: str, **fields) -> None:
    """One line per phase: ``phase: key=value ...``."""
    body = " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in fields.items()
    )
    print(f"{phase}: {body}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def timed(fn, *args):
    """(seconds, result) of ``fn(*args)`` waited to completion."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


def on_cpu(build, *args):
    """``build()(*args)`` on the CPU backend: the function (and every table
    it closes over) is built there, and the inputs are host copies."""
    import jax
    import numpy as np

    cpu = jax.devices("cpu")[0]
    host = jax.tree.map(np.asarray, args)
    with jax.default_device(cpu):
        return jax.device_get(build()(*jax.device_put(host, cpu)))


def diverged_envs(got, want, atol: float):
    """Boolean [B] mask of envs whose rollout output differs anywhere:
    integer leaves exactly, float leaves beyond ``atol``.  ``got`` is
    ``rollout``'s ``(traj, (obs, state))``: ``[T, B, ...]`` trajectory
    leaves, ``[B, ...]`` final leaves."""
    import jax
    import numpy as np

    bad = None
    for time_major, g, w in ((True, got[0], want[0]),
                             (False, got[1], want[1])):
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            a, b = np.asarray(a), np.asarray(b)
            if a.dtype.kind in "iub":
                d = a != b
            else:
                d = np.abs(a.astype(np.float64) - b.astype(np.float64)) > atol
            if time_major:
                d = d.any(axis=0)
            d = d.reshape(d.shape[0], -1).any(axis=1)
            bad = d if bad is None else bad | d
    return bad


def compare(tag: str, got, want, *, exact: bool, atol=0.0, rtol=0.0):
    """Max abs difference of two pytrees; raise past the tolerance."""
    import jax
    import numpy as np

    worst = 0.0
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            raise AssertionError(f"{tag}: shape {a.shape} != {b.shape}")
        if exact or a.dtype.kind in "iub":
            if not np.array_equal(a, b):
                bad = np.argwhere(a != b)[:3].tolist()
                raise AssertionError(f"{tag}: not equal at {bad}")
            continue
        diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
        worst = max(worst, float(diff.max(initial=0.0)))
        if not np.all(diff <= atol + rtol * np.abs(b)):
            raise AssertionError(
                f"{tag}: max |diff| {float(diff.max())} > {atol} + {rtol}|x|"
            )
    return worst


# ----------------------------------------------------------------- phases
def phase_rollouts(S) -> None:
    import importlib.util

    import jax

    import gym_po_tpu as gpt
    from gym_po_tpu.vector import rollout

    spec = importlib.util.spec_from_file_location(
        "suite", os.path.join(ROOT, "benchmarks", "suite.py"))
    suite = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(suite)
    B, T = S["rollout_B"], S["rollout_T"]
    for name, kw in suite.CONFIGS:
        if name.startswith("Ant"):
            continue  # phase 6
        def build(name=name, kw=kw):
            env = gpt.make(name, **kw)
            return jax.jit(lambda k: rollout(env, k, None, B, T))

        env = gpt.make(name, **kw)
        run = build()
        key = jax.random.PRNGKey(0)
        t_first, got = timed(run, key)
        t_run, _ = timed(run, key)
        want = on_cpu(build, key)
        integer = all(x.dtype.kind in "iub" for x in jax.tree.leaves(
            jax.eval_shape(lambda k, env=env: env.reset_vec(k, 1), key)[1]))
        if integer:
            compare(f"rollout {name}", got, want, exact=True)
            n_div = 0
        else:
            n_div = int(diverged_envs(got, want, ROLLOUT_ATOL).sum())
            if n_div > ROLLOUT_MAX_DIVERGED * B:
                raise AssertionError(
                    f"rollout {name}: {n_div} of {B} envs differ from the "
                    f"CPU beyond {ROLLOUT_ATOL}")
        say("rollouts", env=name, kw=json.dumps(kw, sort_keys=True),
            B=B, T=T, state="int" if integer else "f32",
            check="exact" if integer else f"within {ROLLOUT_ATOL}",
            envs_diverged_vs_cpu=n_div, compile_s=t_first - t_run,
            steps_per_s=B * T / t_run)


def _rate(run, args, work, reps=3):
    import jax

    jax.block_until_ready(run(*args))
    best = []
    for _ in range(reps):
        t, _ = timed(run, *args)
        best.append(t)
    return work / sorted(best)[len(best) // 2]


def phase_taxi(S, interpret: bool) -> None:
    import jax
    import jax.numpy as jnp

    import gym_po_tpu as gpt
    from gym_po_tpu.ops.fused_taxi import IMPLS, make_fused_taxi_rollout
    from gym_po_tpu.vector import rollout

    env = gpt.make("HansenTaxi-v4")
    seed = jnp.asarray([5], jnp.int32)
    # bit-identical twins in tape mode at the large batch
    B, K = S["taxi_B"], S["taxi_tape_K"]
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    s = st.s.reshape(-1, 128)
    outs = {}
    for impl in IMPLS:
        run = make_fused_taxi_rollout(env, B, K, rng_tape=True,
                                      episode_stats=True, impl=impl,
                                      interpret=interpret and impl != "xla")
        tape = jax.random.bits(jax.random.PRNGKey(1), run.tape_shape,
                               jnp.uint32).view(jnp.int32)
        outs[impl] = jax.device_get(run(seed, s, tape))
        del tape
    for impl in IMPLS[1:]:
        compare(f"taxi tape {impl}", outs[impl], outs["xla"], exact=True)
    say("taxi", check="tape-mode twins bit-identical", impls="+".join(IMPLS),
        B=B, K=K)
    # throughput, counter generator
    K = S["taxi_K"]
    for B in (S["taxi_B"], S["taxi_small_B"]):
        _, st = env.reset_vec(jax.random.PRNGKey(0), B)
        s = st.s.reshape(-1, 128)
        rates, res = {}, {}
        for impl in IMPLS:
            run = make_fused_taxi_rollout(
                env, B, K, impl=impl, interpret=interpret and impl != "xla")
            res[impl] = jax.device_get(run(seed, s))
            rates[impl] = _rate(run, (seed, s), B * K)
        for impl in IMPLS[1:]:
            compare(f"taxi counter {impl}", res[impl], res["xla"], exact=True)
        scan = jax.jit(lambda k, B=B: rollout(env, k, None, B, K)[0]
                       .reward.sum())
        rates["vector.rollout"] = _rate(scan, (jax.random.PRNGKey(2),), B * K)
        say("taxi", B=B, K=K, **{f"{k}_steps_per_s": v
                                 for k, v in rates.items()})


# Trainer comparisons explore with probability 1 (the actor-critic with a
# frozen policy) from random tables: the tape then fixes every action and
# no two table entries tie exactly, so the card and the CPU walk the same
# trajectories while their tables accumulate the scatter-adds in different
# orders.  (From zero tables with greedy actions, a last-bit difference
# breaks an exact tie differently and the whole batch diverges.)
LR, EXPLORE = 0.1, 1.0
# trainers whose actions or dynamics pass through f32 transcendentals
# (Gumbel noise, Box-Muller), which differ in the last bit between backends
TRANSCENDENTAL = ("rooms-actor-critic", "crooms-q")
# ... and those with a discrete choice that reads the table (the Watkins
# trace cut, double Q's action selection): a near-tie can still flip, so
# they run a shorter chunk (``trainer_K_choice``)
TABLE_DEPENDENT = ("taxi-q(lambda)", "rooms-q(lambda)",
                   "taxi-double-q") + TRANSCENDENTAL


def _trainer_cases(B, K, K_choice):
    """(name, K, build, args) of every fused tabular trainer in tape mode;
    ``build()`` makes the trainer on the current default device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gym_po_tpu as gpt
    from gym_po_tpu import ops
    from gym_po_tpu.ops.fused_qlearning import bank_geometry, q_to_banks

    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(0)
    rows = lambda x: jnp.asarray(np.asarray(x, np.int32).reshape(-1, 128))
    seed = jnp.asarray([3], jnp.int32)

    def table(n, a, nsb=4):
        q = rng.normal(0.0, 0.1, (n, a)).astype(np.float32)
        return jnp.asarray(q_to_banks(q, nsb))

    cases = []

    def add(name, make, *args):
        k = K_choice if name in TABLE_DEPENDENT else K
        build = lambda: make(k)
        shape = build().tape_shape
        tape = jax.random.bits(jax.random.PRNGKey(7), shape,
                               jnp.uint32).view(jnp.int32)
        cases.append((name, k, build, (seed,) + args + (tape,)))

    _, st = gpt.make("Taxi-v4").reset_vec(key, B)
    s = rows(st.s)
    nsb, _ = bank_geometry(500, 5)
    add("taxi-q", lambda k: ops.make_fused_q_trainer(
        gpt.make("Taxi-v4"), B, k, average_duplicates=True, rng_tape=True),
        LR, EXPLORE, s, table(500, 5, nsb))
    add("taxi-q(lambda)", lambda k: ops.make_fused_q_trainer(
        gpt.make("Taxi-v4"), B, k, average_duplicates=True, rng_tape=True,
        lam=0.9), LR, EXPLORE, s, table(500, 5, nsb))
    add("taxi-double-q", lambda k: ops.make_fused_double_q_trainer(
        gpt.make("Taxi-v4"), B, k, rng_tape=True),
        LR, EXPLORE, s, jnp.concatenate([table(500, 5, nsb),
                                         table(500, 5, nsb)]))
    rooms = gpt.make("Rooms-v0")
    _, st = rooms.reset_vec(key, B)
    GW = rooms.grid_np.shape[1]
    agent = rows(st.agent_yx[:, 0] * GW + st.agent_yx[:, 1])
    A = int(rooms.num_actions)
    add("rooms-q", lambda k: ops.make_fused_q_trainer_rooms(
        gpt.make("Rooms-v0"), B, k, average_duplicates=True, rng_tape=True),
        LR, EXPLORE, agent, table(512, A))
    add("rooms-q(lambda)", lambda k: ops.make_fused_qlambda_trainer_rooms(
        gpt.make("Rooms-v0"), B, k, rng_tape=True, average_duplicates=True),
        LR, EXPLORE, agent, table(512, A))
    add("rooms-actor-critic", lambda k: ops.make_fused_ac_trainer_rooms(
        gpt.make("Rooms-v0"), B, k, rng_tape=True),
        0.0, 0.1, table(512, A), table(512, 1), agent)
    ms = gpt.make("MultistoryFourRooms-v0")
    _, st = ms.reset_vec(key, B)
    _, H, GWm = ms.grid_np.shape
    a = st.agent_zyx
    add("msrooms-q", lambda k: ops.make_fused_q_trainer_msrooms(
        gpt.make("MultistoryFourRooms-v0"), B, k, average_duplicates=True,
        rng_tape=True), LR, EXPLORE,
        rows(a[:, 0] * H * GWm + a[:, 1] * GWm + a[:, 2]),
        table(512, int(ms.num_actions)))
    cr = gpt.make("CRooms-v0", action_type="ordinal")
    _, st = cr.reset_vec(key, B)
    f = lambda x: jnp.asarray(np.asarray(x, np.float32).reshape(-1, 128))
    z = jnp.zeros((B // 128, 128), jnp.float32)
    add("crooms-q", lambda k: ops.make_fused_q_trainer_crooms(
        gpt.make("CRooms-v0", action_type="ordinal"), B, k, rng_tape=True),
        LR, EXPLORE, f(st.agent_yx[:, 0]), f(st.agent_yx[:, 1]), z, z,
        table(512, int(cr.num_actions)))
    return cases


def phase_trainers(S) -> None:
    """Each trainer, one tape-mode chunk on the card and on the CPU.

    Per-env outputs (states, reward sums) must agree exactly (ints) or
    within ``ROLLOUT_ATOL`` (floats); where f32 transcendentals steer the
    trajectory (:data:`TRANSCENDENTAL`) at most ``ROLLOUT_MAX_DIVERGED`` of
    the envs may take another path on a last-bit difference.
    Tables must agree within ``QTABLE_RTOL`` of their scale: the card adds
    the duplicates of a scatter in another order.  Where a discrete choice
    reads the table (:data:`TABLE_DEPENDENT`), at most 1% of the entries
    may differ beyond that bound."""
    import numpy as np

    B = S["trainer_B"]
    for name, K, build, args in _trainer_cases(B, S["trainer_K"],
                                               S["trainer_K_choice"]):
        run = build()
        t_first, got = timed(run, *args)
        t_run, got = timed(run, *args)
        want = on_cpu(build, *args)
        per_env = [(np.asarray(g), np.asarray(w)) for g, w in zip(got, want)
                   if np.shape(g) == (B // 128, 128)]
        tables = [(np.asarray(g), np.asarray(w)) for g, w in zip(got, want)
                  if np.shape(g) != (B // 128, 128)]
        div = np.zeros((B // 128, 128), bool)
        for g, w in per_env:
            if g.dtype.kind in "iub":
                div |= g != w
            else:
                div |= np.abs(g.astype(np.float64) - w) > ROLLOUT_ATOL
        n_div = int(div.sum())
        allowed = ROLLOUT_MAX_DIVERGED * B if name in TRANSCENDENTAL else 0
        if n_div > allowed:
            raise AssertionError(f"{name}: {n_div} of {B} envs differ")
        worst, frac = 0.0, 0.0
        for g, w in tables:
            scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
            rel = np.abs(g.astype(np.float64) - w) / scale
            worst = max(worst, float(rel.max()))
            frac = max(frac, float((rel > QTABLE_RTOL).mean()))
        if (frac > 0.01 if name in TABLE_DEPENDENT else worst > QTABLE_RTOL):
            raise AssertionError(
                f"{name}: table max rel diff {worst}, {frac:.3%} of entries "
                f"beyond {QTABLE_RTOL}")
        say("trainers", trainer=name, B=B, K=K, actions="tape",
            envs_diverged_vs_cpu=n_div, table_max_rel_diff_vs_cpu=worst,
            table_entries_beyond_tol=frac, compile_s=t_first - t_run,
            train_steps_per_s=B * K / t_run)


def _ppo(env, cfg, rnn: bool, updates: int):
    """(compile_s, update_s, losses) of ``updates`` PPO updates."""
    import jax
    import numpy as np

    from gym_po_tpu.agents import (init_rnn_state, init_train_state,
                                   make_rnn_train_step, make_train_step)

    if rnn:
        net, ts = init_rnn_state(env, cfg, jax.random.PRNGKey(0))
        step = make_rnn_train_step(env, net, cfg)
    else:
        net, ts = init_train_state(env, cfg, jax.random.PRNGKey(0))
        step = make_train_step(env, net, cfg)
    t0 = time.perf_counter()
    compiled = step.lower(ts).compile()
    compile_s = time.perf_counter() - t0
    losses, times = [], []
    for _ in range(updates):
        t, (ts, m) = timed(compiled, ts)
        times.append(t)
        losses.append(float(m["loss"]))
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite PPO losses {losses}")
    return compile_s, sorted(times)[len(times) // 2], losses


def phase_ppo(S) -> None:
    import gym_po_tpu as gpt
    from gym_po_tpu.agents import PPOConfig

    env = gpt.make("ExtendedHansenTaxi-v4")
    B, T = S["ppo_B"], S["ppo_T"]
    for label, rnn, cfg in (
        ("ppo", False, PPOConfig(num_envs=B, rollout_steps=T)),
        ("gru-ppo", True, PPOConfig(num_envs=B, rollout_steps=T,
                                    shuffle="none")),
    ):
        c, u, losses = _ppo(env, cfg, rnn, S["ppo_updates"])
        say("ppo", learner=label, env="ExtendedHansenTaxi-v4", B=B, T=T,
            compile_s=c, update_s=u, env_steps_per_s=B * T / u,
            losses=",".join(f"{x:.5g}" for x in losses))


def phase_ant(S, pipeline: str) -> None:
    import jax
    import numpy as np

    import gym_po_tpu as gpt
    from gym_po_tpu.agents import PPOConfig
    from gym_po_tpu.vector import rollout

    env = gpt.make("AntTagPhysics-v0", pipeline=pipeline)
    B, T = S["ant_B"], S["ant_T"]
    run = jax.jit(lambda k: rollout(env, k, None, B, T))
    t0 = time.perf_counter()
    compiled = run.lower(jax.random.PRNGKey(0)).compile()
    compile_s = time.perf_counter() - t0
    t, (traj, _) = timed(compiled, jax.random.PRNGKey(0))
    if not np.all(np.isfinite(np.asarray(traj.obs))):
        raise AssertionError("non-finite ant observations")
    say("ant", pipeline=pipeline, B=B, T=T, compile_s=compile_s,
        env_steps_per_s=B * T / t)
    cfg = PPOConfig(num_envs=B, rollout_steps=S["ant_ppo_T"], hidden=(64, 64))
    c, u, losses = _ppo(env, cfg, False, 1)
    say("ant", learner="ppo", pipeline=pipeline, B=B, T=S["ant_ppo_T"],
        compile_s=c, update_s=u, env_steps_per_s=B * S["ant_ppo_T"] / u,
        loss=losses[0])
    # Under random actions the ant's contact dynamics are chaotic: on one
    # backend a 1e-7 m nudge of the torso height moves some envs' qpos by
    # 0.1-0.5 after 10 steps, while most stay within 1e-5.  So the card is
    # held to the bulk of the envs, and the nudge shows the spread that
    # last-bit differences alone produce.
    Bc, Tc = S["ant_cmp_B"], S["ant_cmp_T"]

    def build():
        e = gpt.make("AntTagPhysics-v0", pipeline=pipeline)

        def run(k, dz):
            obs, st = e.reset_vec(k, Bc)
            st = st.replace(qpos=st.qpos.at[:, 2].add(dz))
            init = (obs, st)
            return rollout(e, jax.random.fold_in(k, 1), None, Bc, Tc,
                           init=init)[1][1].qpos

        return jax.jit(run)

    key, zero, nudge = jax.random.PRNGKey(3), np.float32(0), np.float32(1e-7)
    run = build()
    got = np.asarray(run(key, zero), np.float64)
    nudged = np.asarray(run(key, nudge), np.float64)
    want = np.asarray(on_cpu(build, key, zero), np.float64)
    d_cpu = np.abs(got - want).max(axis=1)
    d_nudge = np.abs(got - nudged).max(axis=1)
    q = lambda d: ",".join(f"{x:.3g}" for x in np.quantile(d, [.5, .75, 1]))
    say("ant", check="qpos vs CPU", B=Bc, T=Tc,
        per_env_max_diff_q50_q75_max=q(d_cpu),
        same_card_1e7_nudge_q50_q75_max=q(d_nudge),
        tol_q75=ANT_QPOS_ATOL)
    if np.quantile(d_cpu, 0.75) > ANT_QPOS_ATOL:
        raise AssertionError(f"ant qpos vs CPU: {q(d_cpu)}")


def phase_tests() -> None:
    import pytest

    path = os.path.join(ROOT, "tests", "test_gpu.py")
    rc = pytest.main([path, "-q", "-m", "gpu and not slow",
                      "-p", "no:cacheprovider"])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed: pytest exit {rc}")
    say("tests", file="tests/test_gpu.py", pytest_exit=int(rc))


def phase_four_cards(S) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gym_po_tpu as gpt
    from gym_po_tpu.agents import PPOConfig, init_train_state, make_train_step
    from gym_po_tpu.agents.ppo import (TrainState, make_local_update,
                                      shard_train_state)
    from gym_po_tpu.ops import make_fused_q_trainer, q_to_banks
    from gym_po_tpu.parallel import (chunk_seeds, make_mesh, replicate,
                                     shard_batch, shard_fused_trainer)

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four-cards needs 4 devices, found {len(devs)}")
    mesh = make_mesh(shape=(4,), devices=devs[:4])
    env = gpt.make("ExtendedHansenTaxi-v4")
    cfg = PPOConfig(num_envs=S["four_B"], rollout_steps=S["four_T"])
    net, ts = init_train_state(env, cfg, jax.random.PRNGKey(0))
    # 4 cards: the sharded Anakin update
    ts4 = shard_train_state(ts, mesh)
    step4 = make_train_step(env, net, cfg, mesh)
    t0 = time.perf_counter()
    step4 = step4.lower(ts4).compile()
    c4 = time.perf_counter() - t0
    loss4, t4 = [], []
    for _ in range(S["four_updates"]):
        t, (ts4, m) = timed(step4, ts4)
        t4.append(t)
        loss4.append(float(m["loss"]))
    # 1 card: the same four per-card updates under vmap, same pmean
    local = make_local_update(env, net, cfg, 4, "data")
    axes = TrainState(params=None, opt_state=None, env_obs=0, env_state=0,
                      key=0, update_idx=None)
    vstep = jax.jit(jax.vmap(local, in_axes=(axes,), out_axes=(axes, 0),
                             axis_name="data"))
    split = lambda x: x.reshape(4, x.shape[0] // 4, *x.shape[1:])
    ts1 = jax.device_put(TrainState(
        params=ts.params, opt_state=ts.opt_state,
        env_obs=split(ts.env_obs), env_state=jax.tree.map(split, ts.env_state),
        key=jax.random.split(ts.key, 4), update_idx=ts.update_idx,
    ), devs[0])
    vstep = vstep.lower(ts1).compile()
    loss1, t1 = [], []
    for _ in range(S["four_updates"]):
        t, (ts1, m) = timed(vstep, ts1)
        t1.append(t)
        loss1.append(float(m["loss"][0]))
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(loss4, loss1))
    if rel > FOUR_CARD_RTOL:
        raise AssertionError(f"4-card losses {loss4} vs 1-card {loss1}")
    B, T = S["four_B"], S["four_T"]
    # every update's time: the first sharded call may hold one-time
    # collective set-up
    say("four-cards", learner="ppo", B=B, T=T, compile_s=c4,
        max_rel_loss_diff=rel,
        update_s_4cards=",".join(f"{x:.4g}" for x in t4),
        update_s_1card=",".join(f"{x:.4g}" for x in t1),
        env_steps_per_s_4cards=B * T / sorted(t4)[len(t4) // 2],
        losses_4cards=",".join(f"{x:.6g}" for x in loss4),
        losses_1card=",".join(f"{x:.6g}" for x in loss1))
    # data-parallel tabular trainer: tables identical on every card
    taxi = gpt.make("Taxi-v4")
    Bt, K = S["four_trainer_B"], S["four_trainer_K"]
    run = shard_fused_trainer(
        make_fused_q_trainer(taxi, Bt // 4, K, average_duplicates=True),
        mesh, sharded_args=(2,), averaged_outs=(1,), num_outs=3)
    _, st = taxi.reset_vec(jax.random.PRNGKey(1), Bt)
    s = shard_batch(mesh, jnp.asarray(np.asarray(st.s).reshape(-1, 128)))
    qb = replicate(mesh, jnp.asarray(q_to_banks(np.zeros((500, 5),
                                                         np.float32))))
    times = []
    for i in range(3):
        t, (s, qb, rew) = timed(run, jnp.asarray(chunk_seeds(0, i + 1, 4)),
                                0.1, 0.2, s, qb)
        times.append(t)
    shards = [np.asarray(x.data) for x in qb.addressable_shards]
    if len(shards) != 4 or not all(np.array_equal(shards[0], x)
                                   for x in shards[1:]):
        raise AssertionError("Q tables differ between cards after pmean")
    if not np.isfinite(shards[0]).all() or not np.any(shards[0] != 0):
        raise AssertionError("Q table did not train")
    say("four-cards", trainer="taxi-q data-parallel", B=Bt, K=K,
        tables_identical_on_cards=len(shards),
        chunk_s=sorted(times)[1], train_steps_per_s=Bt * K / sorted(times)[1])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card phase")
    p.add_argument("--rehearse", action="store_true",
                   help="tiny shapes on the CPU backend (no result line)")
    args = p.parse_args()
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four_cards:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4")
    else:
        # the card, and the CPU backend for the reference runs
        os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    import jax

    dev = jax.devices()[0]
    if not args.rehearse and dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from gym_po_tpu.utils import enable_compilation_cache

    S = TINY if args.rehearse else FULL
    card = "rehearsal (CPU)" if args.rehearse else card_line()
    enable_compilation_cache()
    say("device", card=card, jax=jax.__version__, kind=dev.device_kind,
        count=len(jax.devices()))
    if args.four_cards:
        phase_four_cards(S)
        count = 4
    else:
        phase_rollouts(S)
        phase_taxi(S, interpret=args.rehearse)
        phase_trainers(S)
        phase_ppo(S)
        phase_ant(S, ANT_PIPELINE)
        if not args.rehearse:
            phase_tests()
        count = 1
    print(f"card: {card}", flush=True)
    if args.rehearse:
        print("rehearsal passed", flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
