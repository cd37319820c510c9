"""AntTagPhysics / AntHeavenHellPhysics — the full articulated ant POMDPs
on the repo's JAX rigid-body engine.

These are the complete reference environments (reference
``gym_po/envs/ant_tag.py``, ``ant_heaven_hell.py``) with the MuJoCo C
substrate replaced by :mod:`gym_po_tpu.physics` — same 8-DoF quadruped,
same RK4 @ 0.02 s × frame_skip 15, same task layer — as pure-functional
jit/vmap/scan-safe Environments.  Unlike :mod:`.ant` (host MuJoCo, single
env) and :mod:`.tag_jax` (point-mass task surrogates), these run the
articulated body itself on the accelerator in batch.

Task semantics (identical to :mod:`.ant` / the reference):

* **AntTagPhysics** (ant_tag.py:27-158): ±4.5 spawn cage inside ±5.25
  walls.  Target flees 0.5/step {away, 2 orthogonals, stay}, cancelled at
  the cage edge; spawns ≥ 5.0 from the ant.  Obs (29) = qpos[2:] + qvel +
  target-xy-if-within-3.0-else-zeros.  Tag ≤ 1.5 → +1, terminal.
* **AntHeavenHellPhysics** (ant_heaven_hell.py:29-137): T-maze, heaven at
  (±6.25, 6.0) coin-flipped per episode, priest at (0, 6.0), radius 2.0.
  Obs (28) = qpos[2:] + qvel + heaven-direction-iff-near-priest.
  Reaching heaven/hell → ±1, terminal.

Physics accuracy knobs: ``solver_iters`` (primal-Newton iterations per
integrator stage — 12 reproduces MuJoCo's constraint fixed point to ~1e-12
at f64; the default 8 with cross-step warm starts is within f32 noise —
validated: over 120-200 contact-rich RK4 steps the f32/iters=8 default
tracks the f64/iters=15 parity configuration to < 5e-5 m position drift
with penetration bounded at ~3.7 mm and finite energy, see
``tests/test_physics_contact.py::
test_f32_default_config_tracks_f64_parity_config``),
``integrator`` (``"rk4"`` = the reference setting; ``"euler"`` = one
constrained solve per substep, ~4x cheaper, see ``physics.engine``), and
warm starts carried in the env state.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import Box, Environment, EnvState
from ..physics import HEAVEN_HELL_WALLS, TAG_WALLS, make_ant_model
from ..physics.engine import PhysicsState, step as physics_step

__all__ = [
    "AntTagPhysics",
    "AntTagPhysicsState",
    "AntHeavenHellPhysics",
    "AntHeavenHellPhysicsState",
]

# nominal standing pose (same as envs/ant.py:_STAND_POSE)
STAND_POSE = np.array(
    [0.0, 0.0, 0.55, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, -1.0, 0.0, -1.0,
     0.0, 1.0], np.float32,
)
_NQ, _NV = 15, 14

CAGE = 4.5
VISIBLE_RADIUS = 3.0
TAG_RADIUS = 1.5
MIN_SPAWN_DIST = 5.0
TARGET_STEP = 0.5

HH_SITES = np.array([[-6.25, 6.0], [6.25, 6.0], [0.0, 6.0]], np.float32)
HH_RADIUS = 2.0


class AntTagPhysicsState(EnvState):
    qpos: jax.Array      # f32 [15]
    qvel: jax.Array      # f32 [14]
    warm: jax.Array      # f32 [14] solver warm start (qacc - qacc_smooth)
    target_xy: jax.Array  # f32 [2]


class AntHeavenHellPhysicsState(EnvState):
    qpos: jax.Array
    qvel: jax.Array
    warm: jax.Array
    heaven_right: jax.Array  # bool []


def _move_target(agent_xy, target_xy, mode):
    """Reference flee rule (ant_tag.py:105-123): 0.5 {away, ⊥left, ⊥right,
    stay}, cancelled at the cage edge; stays put at zero distance."""
    away = agent_xy - target_xy
    nrm = jnp.sqrt((away**2).sum())
    safe = nrm > 1e-9
    away = jnp.where(safe, away / jnp.where(safe, nrm, 1.0), 0.0)
    steps = jnp.stack(
        [-away, jnp.stack([away[1], -away[0]]),
         jnp.stack([-away[1], away[0]]), jnp.zeros_like(away)]
    )
    new = target_xy + steps[mode] * TARGET_STEP
    oob = (jnp.abs(new) > CAGE).any()
    return jnp.where(oob | ~safe, target_xy, new)


class _AntPhysicsBase(Environment):
    """Shared physics plumbing; subclasses add the task layer."""

    def __init__(self, walls, time_limit: int, frame_skip: int,
                 solver_iters: int, integrator: str = "rk4",
                 ls_iters: int = 10, pipeline: str = "scalar"):
        self.model = make_ant_model(walls)
        self.time_limit = int(time_limit)
        self.frame_skip = int(frame_skip)
        self.solver_iters = int(solver_iters)
        self.ls_iters = int(ls_iters)
        self.pipeline = str(pipeline)
        self.integrator = str(integrator)
        self._action_space = Box(-1.0, 1.0, (8,), dtype=jnp.float32)

    @property
    def action_space(self) -> Box:
        return self._action_space

    @property
    def observation_space(self) -> Box:
        return self._observation_space

    def _physics(self, qpos, qvel, warm, action):
        ps = PhysicsState(qpos, qvel, warm)
        out = physics_step(self.model, ps, jnp.clip(action, -1.0, 1.0),
                           frame_skip=self.frame_skip,
                           iters=self.solver_iters,
                           integrator=self.integrator,
                           ls_iters=self.ls_iters,
                           pipeline=self.pipeline)
        return out.qpos, out.qvel, out.warm

    def _spawn_qpos(self, key, lo_xy, hi_xy):
        xy = jax.random.uniform(
            key, (2,), jnp.float32, jnp.asarray(lo_xy, jnp.float32),
            jnp.asarray(hi_xy, jnp.float32),
        )
        return jnp.asarray(STAND_POSE).at[:2].set(xy)

    def _spawn_qpos_vec(self, key, num, lo_xy, hi_xy):
        xy = jax.random.uniform(
            key, (num, 2), jnp.float32, jnp.asarray(lo_xy, jnp.float32),
            jnp.asarray(hi_xy, jnp.float32),
        )
        return jnp.broadcast_to(
            jnp.asarray(STAND_POSE), (num, _NQ)
        ).at[:, :2].set(xy)

    def _core_obs(self, qpos, qvel):
        return jnp.concatenate([qpos[..., 2:], qvel], -1)


class AntTagPhysics(_AntPhysicsBase):
    """Articulated ant tag (full reference env, JAX physics)."""

    name = "AntTagPhysics-v0"

    def __init__(self, time_limit: int = 500, frame_skip: int = 15,
                 solver_iters: int = 8, integrator: str = "rk4",
                 ls_iters: int = 10, pipeline: str = "scalar",
                 visible_radius: float = VISIBLE_RADIUS):
        """``visible_radius``: target visibility cutoff (reference
        ant_tag.py:77-86 uses 3.0); smaller = deeper partial
        observability, the memory-pays regime."""
        super().__init__(TAG_WALLS, time_limit, frame_skip, solver_iters,
                         integrator, ls_iters, pipeline)
        self.visible_radius = float(visible_radius)
        self._observation_space = Box(
            -jnp.inf, jnp.inf, (29,), dtype=jnp.float32
        )

    # ------------------------------------------------------------ task bits
    def _spawn_target(self, key, agent_xy):
        """Uniform in the cage conditioned on dist ≥ 5.0 from the ant — the
        reference's rejection-resample loop (ant_tag.py:94-100) as a bounded
        ``lax.while_loop``: keep redrawing until the draw qualifies.

        Exact conditional distribution (no fallback atom; the earlier
        8-candidates + farthest-corner scheme put ~5-10% of episodes on a
        corner point for centrally-spawned ants).  The per-draw success
        probability is ≥ ~10% (worst case: ant at the cage center), so the
        256-iteration bound is hit with probability ≤ 0.9^256 ≈ 2e-12; under
        vmap the loop runs until every lane qualifies (~30 masked iterations
        of two uniforms at B=16k — noise next to one constraint solve).
        Distribution test: ``tests/test_ant_physics_env.py``
        (test_tag_spawn_distribution)."""
        def cond(carry):
            _, xy, i = carry
            far = ((xy - agent_xy) ** 2).sum() >= MIN_SPAWN_DIST**2
            return ~far & (i < 256)

        def body(carry):
            k, _, i = carry
            k, kd = jax.random.split(k)
            xy = jax.random.uniform(kd, (2,), jnp.float32, -CAGE, CAGE)
            return k, xy, i + 1

        k, kd = jax.random.split(key)
        xy0 = jax.random.uniform(kd, (2,), jnp.float32, -CAGE, CAGE)
        _, xy, _ = jax.lax.while_loop(
            cond, body, (k, xy0, jnp.zeros((), jnp.int32))
        )
        return xy

    def observe(self, state: AntTagPhysicsState) -> jax.Array:
        d2 = ((state.qpos[:2] - state.target_xy) ** 2).sum()
        tail = jnp.where(
            d2 < self.visible_radius**2, state.target_xy,
            jnp.zeros(2, jnp.float32)
        )
        return jnp.concatenate([self._core_obs(state.qpos, state.qvel), tail])

    # -------------------------------------------------------------- protocol
    def _fresh(self, key) -> AntTagPhysicsState:
        ka, kt = jax.random.split(key)
        qpos = self._spawn_qpos(ka, (-CAGE, -CAGE), (CAGE, CAGE))
        target = self._spawn_target(kt, qpos[:2])
        return AntTagPhysicsState(
            elapsed=jnp.zeros((), jnp.int32),
            qpos=qpos,
            qvel=jnp.zeros(_NV, jnp.float32),
            warm=jnp.zeros(_NV, jnp.float32),
            target_xy=target,
        )

    def reset_env(self, key) -> Tuple[jax.Array, AntTagPhysicsState]:
        state = self._fresh(key)
        return self.observe(state), state

    def step_env(self, key, state, action):
        km, kr = jax.random.split(key)
        qpos, qvel, f = self._physics(
            state.qpos, state.qvel, state.warm, action
        )
        mode = jax.random.randint(km, (), 0, 4)
        target = _move_target(qpos[:2], state.target_xy, mode)
        d2 = ((qpos[:2] - target) ** 2).sum()
        done = d2 <= TAG_RADIUS**2
        rew = done.astype(jnp.float32)
        elapsed = state.elapsed + 1
        trunc = (elapsed >= self.time_limit) & ~done
        mid = AntTagPhysicsState(
            elapsed=elapsed, qpos=qpos, qvel=qvel, warm=f, target_xy=target
        )
        reset = done | trunc
        fresh = self._fresh(kr)
        new_state = jax.tree_util.tree_map(
            lambda n, o: jnp.where(reset, n, o), fresh, mid
        )
        info = {"terminal_state": mid, "reset_mask": reset}
        return self.observe(new_state), new_state, rew, done, trunc, info

    # ----------------------------------------------------- batched fast path
    def _fresh_vec(self, key, num) -> AntTagPhysicsState:
        ka, kt = jax.random.split(key)
        qpos = self._spawn_qpos_vec(ka, num, (-CAGE, -CAGE), (CAGE, CAGE))
        target = jax.vmap(self._spawn_target)(
            jax.random.split(kt, num), qpos[:, :2]
        )
        # target spawn uses per-env candidate draws (cheap: reset-only)
        return AntTagPhysicsState(
            elapsed=jnp.zeros(num, jnp.int32),
            qpos=qpos,
            qvel=jnp.zeros((num, _NV), jnp.float32),
            warm=jnp.zeros((num, _NV), jnp.float32),
            target_xy=target,
        )

    def reset_vec(self, key, num_envs):
        state = self._fresh_vec(key, num_envs)
        return jax.vmap(self.observe)(state), state

    def step_vec(self, key, state, action):
        B = action.shape[0]
        km, kr = jax.random.split(key)
        qpos, qvel, f = jax.vmap(self._physics)(
            state.qpos, state.qvel, state.warm, action
        )
        mode = jax.random.randint(km, (B,), 0, 4)
        target = jax.vmap(_move_target)(qpos[:, :2], state.target_xy, mode)
        d2 = ((qpos[:, :2] - target) ** 2).sum(-1)
        done = d2 <= TAG_RADIUS**2
        rew = done.astype(jnp.float32)
        elapsed = state.elapsed + 1
        trunc = (elapsed >= self.time_limit) & ~done
        mid = AntTagPhysicsState(
            elapsed=elapsed, qpos=qpos, qvel=qvel, warm=f, target_xy=target
        )
        reset = done | trunc
        fresh = self._fresh_vec(kr, B)
        new_state = jax.tree_util.tree_map(
            lambda n, o: jnp.where(
                reset.reshape((B,) + (1,) * (o.ndim - 1)), n, o
            ),
            fresh, mid,
        )
        info = {"terminal_state": mid, "reset_mask": reset}
        return (
            jax.vmap(self.observe)(new_state), new_state, rew, done, trunc,
            info,
        )


class AntHeavenHellPhysics(_AntPhysicsBase):
    """Articulated ant T-maze (full reference env, JAX physics)."""

    name = "AntHeavenHellPhysics-v0"

    def __init__(self, time_limit: int = 500, frame_skip: int = 15,
                 solver_iters: int = 8, integrator: str = "rk4",
                 ls_iters: int = 10, pipeline: str = "scalar"):
        super().__init__(HEAVEN_HELL_WALLS, time_limit, frame_skip,
                         solver_iters, integrator, ls_iters, pipeline)
        self._observation_space = Box(
            -jnp.inf, jnp.inf, (28,), dtype=jnp.float32
        )

    def observe(self, state: AntHeavenHellPhysicsState) -> jax.Array:
        sites = jnp.asarray(HH_SITES)
        reveal = ((state.qpos[:2] - sites[2]) ** 2).sum() <= HH_RADIUS**2
        direction = jnp.where(state.heaven_right, 1.0, -1.0)
        tail = jnp.where(reveal, direction, 0.0).astype(jnp.float32)
        return jnp.concatenate(
            [self._core_obs(state.qpos, state.qvel), tail[None]]
        )

    def _fresh(self, key) -> AntHeavenHellPhysicsState:
        ka, kh = jax.random.split(key)
        # reference spawns x in [-1, 1], y in [0, 1] (ant_heaven_hell.py:50-75)
        qpos = self._spawn_qpos(ka, (-1.0, 0.0), (1.0, 1.0))
        return AntHeavenHellPhysicsState(
            elapsed=jnp.zeros((), jnp.int32),
            qpos=qpos,
            qvel=jnp.zeros(_NV, jnp.float32),
            warm=jnp.zeros(_NV, jnp.float32),
            heaven_right=jax.random.bernoulli(kh),
        )

    def reset_env(self, key):
        state = self._fresh(key)
        return self.observe(state), state

    def _task(self, qpos, heaven_right):
        sites = jnp.asarray(HH_SITES)
        d2 = ((qpos[:2][None] - sites) ** 2).sum(-1)      # [3]
        reached = d2[:2] <= HH_RADIUS**2
        done = reached.any()
        heaven_idx = jnp.where(heaven_right, 1, 0)
        rew = jnp.where(
            done,
            jnp.where(d2[heaven_idx] <= HH_RADIUS**2, 1.0, -1.0),
            0.0,
        ).astype(jnp.float32)
        return done, rew

    def step_env(self, key, state, action):
        qpos, qvel, f = self._physics(
            state.qpos, state.qvel, state.warm, action
        )
        done, rew = self._task(qpos, state.heaven_right)
        elapsed = state.elapsed + 1
        trunc = (elapsed >= self.time_limit) & ~done
        mid = AntHeavenHellPhysicsState(
            elapsed=elapsed, qpos=qpos, qvel=qvel, warm=f,
            heaven_right=state.heaven_right,
        )
        reset = done | trunc
        fresh = self._fresh(key)
        new_state = jax.tree_util.tree_map(
            lambda n, o: jnp.where(reset, n, o), fresh, mid
        )
        info = {"terminal_state": mid, "reset_mask": reset}
        return self.observe(new_state), new_state, rew, done, trunc, info

    def _fresh_vec(self, key, num) -> AntHeavenHellPhysicsState:
        ka, kh = jax.random.split(key)
        qpos = self._spawn_qpos_vec(ka, num, (-1.0, 0.0), (1.0, 1.0))
        return AntHeavenHellPhysicsState(
            elapsed=jnp.zeros(num, jnp.int32),
            qpos=qpos,
            qvel=jnp.zeros((num, _NV), jnp.float32),
            warm=jnp.zeros((num, _NV), jnp.float32),
            heaven_right=jax.random.bernoulli(kh, shape=(num,)),
        )

    def reset_vec(self, key, num_envs):
        state = self._fresh_vec(key, num_envs)
        return jax.vmap(self.observe)(state), state

    def step_vec(self, key, state, action):
        B = action.shape[0]
        qpos, qvel, f = jax.vmap(self._physics)(
            state.qpos, state.qvel, state.warm, action
        )
        done, rew = jax.vmap(self._task)(qpos, state.heaven_right)
        elapsed = state.elapsed + 1
        trunc = (elapsed >= self.time_limit) & ~done
        mid = AntHeavenHellPhysicsState(
            elapsed=elapsed, qpos=qpos, qvel=qvel, warm=f,
            heaven_right=state.heaven_right,
        )
        reset = done | trunc
        fresh = self._fresh_vec(key, B)
        new_state = jax.tree_util.tree_map(
            lambda n, o: jnp.where(
                reset.reshape((B,) + (1,) * (o.ndim - 1)), n, o
            ),
            fresh, mid,
        )
        info = {"terminal_state": mid, "reset_mask": reset}
        return (
            jax.vmap(self.observe)(new_state), new_state, rew, done, trunc,
            info,
        )
