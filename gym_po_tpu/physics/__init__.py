"""JAX articulated rigid-body physics for the ant POMDPs.

A from-scratch JAX re-implementation of the subset of MuJoCo the reference's
ant envs use (reference ``gym_po/envs/ant_tag.py`` / ``ant_heaven_hell.py``
drive MuJoCo's C pipeline):

* :mod:`.spatial` — quaternion/SO(3) algebra (MuJoCo wxyz conventions)
* :mod:`.ant_model` — static model derived from the mjcf leg spec
* :mod:`.dynamics` — FK + world-frame Jacobian formulation of CRBA/RNEA
* :mod:`.contact` — static-shape collision + soft-constraint APGD solver
* :mod:`.engine` — RK4 step on the qpos manifold, vmap-batched

Smooth dynamics match MuJoCo to machine precision at f64; the constraint
solver follows MuJoCo's soft-constraint model (solref/solimp) so contact
behavior is directly comparable.  Everything is pure-functional, static
shape, and batches with ``jax.vmap`` — no host callbacks, no MuJoCo runtime
dependency.
"""

from .ant_model import AntModel, HEAVEN_HELL_WALLS, TAG_WALLS, make_ant_model

__all__ = ["AntModel", "make_ant_model", "TAG_WALLS", "HEAVEN_HELL_WALLS"]
