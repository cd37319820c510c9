"""TagContinuous / HeavenHellContinuous — pure-JAX re-expressions of the
ant POMDP *tasks* (point-mass dynamics).

The reference's AntTag/AntHeavenHell couple two things: a MuJoCo ant body
(CPU C physics) and a POMDP task layer (visibility-limited fleeing target;
priest-revealed heaven).  The task layer is what makes them POMDPs — and it
is exactly re-expressible as pure-functional JAX step/reset (north star:
"ant_tag re-expressed as pure-functional JAX step/reset").  These envs keep
every task constant from the reference (cage/visibility/tag radii, target
flee rule, heaven/hell/priest geometry, terminal rewards — reference
``ant_tag.py:27-158``, ``ant_heaven_hell.py:29-137``) and replace the ant
body with a velocity-clamped point mass, making them jit/vmap/scan-safe and
batch-vectorizable like the rest of the suite.  The MuJoCo envs
(:mod:`gym_po_tpu.envs.ant`) remain for full-physics parity; MJX was not
available in this build environment for the articulated body.

* **TagContinuous**: closed ±4.5 cage.  Agent moves by a clipped [2] force
  (max speed 0.25/step ≈ the ant's effective speed per control step).  The
  target moves 0.5 per step {away, two orthogonals, stay} uniformly,
  cancelled at the cage edge (reference ant_tag.py:105-123).  Obs = own xy
  (odometry; the ant's proprioception serves this role) + target xy if
  within 3.0 else zeros + visibility flag.  Tag within 1.5 → +1, terminal.
  Target spawns ≥ 5.0 from the agent (fixed-iteration masked resampling
  with a farthest-corner fallback — always ≥ 6.3 away).
* **HeavenHellContinuous**: T-maze free space = stem ∪ bar rectangles
  (matching the mjcf wall layout); moves leaving the free space are
  cancelled.  Heaven/hell at (±6.25, 6.0), priest at (0, 6.0), radius 2.0;
  obs = own xy + heaven direction iff within the priest radius.  Reaching
  heaven/hell gives ±1, terminal.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import Box, Environment, EnvState

__all__ = [
    "TagContinuous",
    "TagState",
    "HeavenHellContinuous",
    "HeavenHellState",
]

# ------------------------------------------------------------------ tag
CAGE = 4.5
VISIBLE_RADIUS = 3.0
TAG_RADIUS = 1.5
MIN_SPAWN_DIST = 5.0
TARGET_STEP = 0.5
AGENT_SPEED = 0.25


class TagState(EnvState):
    agent_xy: jax.Array  # f32 [2]
    target_xy: jax.Array  # f32 [2]


class TagContinuous(Environment[TagState]):
    """Point-mass tag POMDP (task constants from reference ant_tag.py)."""

    def __init__(self, time_limit: int = 500, agent_speed: float = AGENT_SPEED,
                 visible_radius: float = VISIBLE_RADIUS):
        """``visible_radius``: target visibility cutoff (reference
        ant_tag.py:77-86 uses 3.0).  Smaller values deepen the partial
        observability — the memory-pays regime."""
        self.name = "TagContinuous-v0"
        self.time_limit = int(time_limit)
        self.agent_speed = float(agent_speed)
        self.visible_radius = float(visible_radius)
        self._action_space = Box(-1.0, 1.0, (2,), dtype=jnp.float32)
        hi = np.array([CAGE, CAGE, CAGE, CAGE, 1.0], np.float32)
        self._observation_space = Box(-hi, hi, (5,), dtype=jnp.float32)

    @property
    def action_space(self) -> Box:
        return self._action_space

    @property
    def observation_space(self) -> Box:
        return self._observation_space

    # ------------------------------------------------ deterministic stages
    def move_target(
        self, agent: jax.Array, target: jax.Array, mode: jax.Array
    ) -> jax.Array:
        """Reference ant_tag.py:105-123 with a zero-distance guard."""
        away = target - agent  # flee direction = -(agent - target)
        nrm = jnp.sqrt((away * away).sum())
        away = jnp.where(nrm > 1e-9, away / jnp.maximum(nrm, 1e-9), 0.0)
        ortho1 = jnp.stack([-away[1], away[0]])
        ortho2 = -ortho1
        step = jnp.select(
            [mode == 0, mode == 1, mode == 2],
            [away, ortho1, ortho2],
            jnp.zeros(2),
        )
        new = target + step * TARGET_STEP
        return jnp.where((jnp.abs(new) > CAGE).any(), target, new)

    def observe(self, state: TagState) -> jax.Array:
        d = state.agent_xy - state.target_xy
        visible = (d * d).sum() < self.visible_radius**2
        tgt = jnp.where(visible, state.target_xy, jnp.zeros(2))
        return jnp.concatenate(
            [state.agent_xy, tgt, visible[None].astype(jnp.float32)]
        )

    def sample_spawn(self, key: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """Agent uniform in the cage; target >= MIN_SPAWN_DIST away
        (reference ant_tag.py:88-103; fixed-iteration + corner fallback)."""
        ka, kt = jax.random.split(key)
        agent = jax.random.uniform(ka, (2,), jnp.float32, -CAGE, CAGE)
        cands = jax.random.uniform(kt, (8, 2), jnp.float32, -CAGE, CAGE)
        dist2 = ((cands - agent[None]) ** 2).sum(-1)
        ok = dist2 >= MIN_SPAWN_DIST**2
        corners = jnp.array(
            [[-CAGE, -CAGE], [-CAGE, CAGE], [CAGE, -CAGE], [CAGE, CAGE]],
            jnp.float32,
        )
        far_corner = corners[jnp.argmax(((corners - agent[None]) ** 2).sum(-1))]
        # first valid candidate, else the farthest corner (always >= 6.3)
        idx = jnp.argmax(ok)
        target = jnp.where(ok.any(), cands[idx], far_corner)
        return agent, target

    # --------------------------------------------------------------- protocol
    def reset_env(self, key: jax.Array) -> Tuple[jax.Array, TagState]:
        agent, target = self.sample_spawn(key)
        state = TagState(
            elapsed=jnp.zeros((), jnp.int32), agent_xy=agent, target_xy=target
        )
        return self.observe(state), state

    def step_env(
        self, key: jax.Array, state: TagState, action: jax.Array
    ) -> Tuple[jax.Array, TagState, jax.Array, jax.Array, jax.Array, Dict[str, Any]]:
        km, kr = jax.random.split(key)
        force = jnp.clip(action.reshape(2), -1.0, 1.0)
        agent = jnp.clip(state.agent_xy + force * self.agent_speed, -CAGE, CAGE)
        mode = jax.random.randint(km, (), 0, 4)
        target = self.move_target(agent, state.target_xy, mode)
        d2 = ((agent - target) ** 2).sum()
        done = d2 <= TAG_RADIUS**2
        rew = jnp.where(done, jnp.float32(1.0), jnp.float32(0.0))
        elapsed = state.elapsed + 1
        trunc = elapsed >= self.time_limit
        mid = TagState(elapsed=elapsed, agent_xy=agent, target_xy=target)
        reset_mask = done | trunc
        na, nt = self.sample_spawn(kr)
        new_state = TagState(
            elapsed=jnp.where(reset_mask, 0, elapsed),
            agent_xy=jnp.where(reset_mask, na, agent),
            target_xy=jnp.where(reset_mask, nt, target),
        )
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return self.observe(new_state), new_state, rew, done, trunc, info

    # ------------------------------------------------------ batched fast path
    def _sample_spawn_vec(self, key: jax.Array, num: int):
        ka, kt = jax.random.split(key)
        agent = jax.random.uniform(ka, (num, 2), jnp.float32, -CAGE, CAGE)
        cands = jax.random.uniform(kt, (num, 8, 2), jnp.float32, -CAGE, CAGE)
        dist2 = ((cands - agent[:, None]) ** 2).sum(-1)  # [num, 8]
        ok = dist2 >= MIN_SPAWN_DIST**2
        corners = jnp.array(
            [[-CAGE, -CAGE], [-CAGE, CAGE], [CAGE, -CAGE], [CAGE, CAGE]],
            jnp.float32,
        )
        cd = ((corners[None] - agent[:, None]) ** 2).sum(-1)  # [num, 4]
        far = corners[jnp.argmax(cd, -1)]  # [num, 2]
        idx = jnp.argmax(ok, -1)
        picked = jnp.take_along_axis(cands, idx[:, None, None], 1)[:, 0]
        target = jnp.where(ok.any(-1)[:, None], picked, far)
        return agent, target

    def reset_vec(self, key: jax.Array, num_envs: int):
        agent, target = self._sample_spawn_vec(key, num_envs)
        state = TagState(
            elapsed=jnp.zeros(num_envs, jnp.int32),
            agent_xy=agent,
            target_xy=target,
        )
        return jax.vmap(self.observe)(state), state

    def step_vec(self, key: jax.Array, state: TagState, action: jax.Array):
        B = action.shape[0]
        km, kr = jax.random.split(key)
        force = jnp.clip(action.reshape(B, 2), -1.0, 1.0)
        agent = jnp.clip(state.agent_xy + force * self.agent_speed, -CAGE, CAGE)
        mode = jax.random.randint(km, (B,), 0, 4)
        target = jax.vmap(self.move_target)(agent, state.target_xy, mode)
        d2 = ((agent - target) ** 2).sum(-1)
        done = d2 <= TAG_RADIUS**2
        rew = done.astype(jnp.float32)
        elapsed = state.elapsed + 1
        trunc = elapsed >= self.time_limit
        mid = TagState(elapsed=elapsed, agent_xy=agent, target_xy=target)
        reset = done | trunc
        na, nt = self._sample_spawn_vec(kr, B)
        new_state = TagState(
            elapsed=jnp.where(reset, 0, elapsed),
            agent_xy=jnp.where(reset[:, None], na, agent),
            target_xy=jnp.where(reset[:, None], nt, target),
        )
        info = {"terminal_state": mid, "reset_mask": reset}
        return (
            jax.vmap(self.observe)(new_state),
            new_state,
            rew,
            done,
            trunc,
            info,
        )


# ----------------------------------------------------------- heaven/hell
HH_SITES = np.array([[-6.25, 6.0], [6.25, 6.0], [0.0, 6.0]], np.float32)
HH_RADIUS = 2.0
# free space: stem corridor + top bar (mjcf.ant_heaven_hell_xml walls)
STEM = (-2.0, 2.0, -1.5, 4.5)  # x_lo, x_hi, y_lo, y_hi
BAR = (-8.0, 8.0, 4.0, 8.0)


class HeavenHellState(EnvState):
    agent_xy: jax.Array  # f32 [2]
    heaven_right: jax.Array  # bool [] — heaven on the +x side this episode


class HeavenHellContinuous(Environment[HeavenHellState]):
    """Point-mass T-maze POMDP (task constants from reference
    ant_heaven_hell.py)."""

    def __init__(self, time_limit: int = 500, agent_speed: float = AGENT_SPEED):
        self.name = "HeavenHellContinuous-v0"
        self.time_limit = int(time_limit)
        self.agent_speed = float(agent_speed)
        self._action_space = Box(-1.0, 1.0, (2,), dtype=jnp.float32)
        hi = np.array([8.0, 8.0, 1.0], np.float32)
        self._observation_space = Box(-hi, hi, (3,), dtype=jnp.float32)

    @property
    def action_space(self) -> Box:
        return self._action_space

    @property
    def observation_space(self) -> Box:
        return self._observation_space

    @staticmethod
    def _in_free_space(xy: jax.Array) -> jax.Array:
        in_stem = (
            (xy[0] >= STEM[0]) & (xy[0] <= STEM[1])
            & (xy[1] >= STEM[2]) & (xy[1] <= STEM[3])
        )
        in_bar = (
            (xy[0] >= BAR[0]) & (xy[0] <= BAR[1])
            & (xy[1] >= BAR[2]) & (xy[1] <= BAR[3])
        )
        return in_stem | in_bar

    def observe(self, state: HeavenHellState) -> jax.Array:
        d = state.agent_xy - jnp.asarray(HH_SITES[2])
        near_priest = (d * d).sum() <= HH_RADIUS**2
        direction = jnp.where(
            near_priest,
            jnp.where(state.heaven_right, jnp.float32(1.0), jnp.float32(-1.0)),
            jnp.float32(0.0),
        )
        return jnp.concatenate([state.agent_xy, direction[None]])

    def sample_spawn(self, key: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """x ~ U(-1,1), y ~ U(0,1), heaven side fair coin
        (reference ant_heaven_hell.py:50-75, 100-110)."""
        kx, kh = jax.random.split(key)
        xy = jax.random.uniform(kx, (2,), jnp.float32) * jnp.asarray(
            [2.0, 1.0]
        ) + jnp.asarray([-1.0, 0.0])
        return xy, jax.random.bernoulli(kh)

    def reset_env(self, key: jax.Array) -> Tuple[jax.Array, HeavenHellState]:
        xy, hv = self.sample_spawn(key)
        state = HeavenHellState(
            elapsed=jnp.zeros((), jnp.int32), agent_xy=xy, heaven_right=hv
        )
        return self.observe(state), state

    def step_env(
        self, key: jax.Array, state: HeavenHellState, action: jax.Array
    ) -> Tuple[jax.Array, HeavenHellState, jax.Array, jax.Array, jax.Array, Dict[str, Any]]:
        force = jnp.clip(action.reshape(2), -1.0, 1.0)
        proposed = state.agent_xy + force * self.agent_speed
        ok = self._in_free_space(proposed)
        agent = jnp.where(ok, proposed, state.agent_xy)
        sites = jnp.asarray(HH_SITES)
        d2 = ((agent[None, :] - sites) ** 2).sum(-1)  # heaven-, hell+, priest
        at_left = d2[0] <= HH_RADIUS**2
        at_right = d2[1] <= HH_RADIUS**2
        done = at_left | at_right
        reached_heaven = jnp.where(state.heaven_right, at_right, at_left)
        rew = jnp.where(
            done,
            jnp.where(reached_heaven, jnp.float32(1.0), jnp.float32(-1.0)),
            jnp.float32(0.0),
        )
        elapsed = state.elapsed + 1
        trunc = elapsed >= self.time_limit
        mid = HeavenHellState(
            elapsed=elapsed, agent_xy=agent, heaven_right=state.heaven_right
        )
        reset_mask = done | trunc
        nxy, nhv = self.sample_spawn(key)
        new_state = HeavenHellState(
            elapsed=jnp.where(reset_mask, 0, elapsed),
            agent_xy=jnp.where(reset_mask, nxy, agent),
            heaven_right=jnp.where(reset_mask, nhv, state.heaven_right),
        )
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return self.observe(new_state), new_state, rew, done, trunc, info

    # ------------------------------------------------------ batched fast path
    def reset_vec(self, key: jax.Array, num_envs: int):
        kx, kh = jax.random.split(key)
        xy = jax.random.uniform(kx, (num_envs, 2), jnp.float32) * jnp.asarray(
            [2.0, 1.0]
        ) + jnp.asarray([-1.0, 0.0])
        hv = jax.random.bernoulli(kh, shape=(num_envs,))
        state = HeavenHellState(
            elapsed=jnp.zeros(num_envs, jnp.int32), agent_xy=xy, heaven_right=hv
        )
        return jax.vmap(self.observe)(state), state

    def step_vec(self, key: jax.Array, state: HeavenHellState, action: jax.Array):
        B = action.shape[0]
        force = jnp.clip(action.reshape(B, 2), -1.0, 1.0)
        proposed = state.agent_xy + force * self.agent_speed
        ok = jax.vmap(self._in_free_space)(proposed)
        agent = jnp.where(ok[:, None], proposed, state.agent_xy)
        sites = jnp.asarray(HH_SITES)
        d2 = ((agent[:, None, :] - sites[None]) ** 2).sum(-1)  # [B, 3]
        at_left = d2[:, 0] <= HH_RADIUS**2
        at_right = d2[:, 1] <= HH_RADIUS**2
        done = at_left | at_right
        reached_heaven = jnp.where(state.heaven_right, at_right, at_left)
        rew = jnp.where(done, jnp.where(reached_heaven, 1.0, -1.0), 0.0).astype(
            jnp.float32
        )
        elapsed = state.elapsed + 1
        trunc = elapsed >= self.time_limit
        mid = HeavenHellState(
            elapsed=elapsed, agent_xy=agent, heaven_right=state.heaven_right
        )
        reset = done | trunc
        kx, kh = jax.random.split(key)
        nxy = jax.random.uniform(kx, (B, 2), jnp.float32) * jnp.asarray(
            [2.0, 1.0]
        ) + jnp.asarray([-1.0, 0.0])
        nhv = jax.random.bernoulli(kh, shape=(B,))
        new_state = HeavenHellState(
            elapsed=jnp.where(reset, 0, elapsed),
            agent_xy=jnp.where(reset[:, None], nxy, agent),
            heaven_right=jnp.where(reset, nhv, state.heaven_right),
        )
        info = {"terminal_state": mid, "reset_mask": reset}
        return (
            jax.vmap(self.observe)(new_state),
            new_state,
            rew,
            done,
            trunc,
            info,
        )
