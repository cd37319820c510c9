"""Fused K-step rollouts and tabular trainers (plain JAX; the taxi rollout
also as a Pallas/Triton GPU kernel), driven by a counter-based generator."""

from .fused_ac import make_fused_ac_trainer_rooms
from .fused_crooms import make_fused_crooms_rollout
from .fused_msrooms import make_fused_msrooms_rollout
from .fused_double_q import make_fused_double_q_trainer
from .fused_q_crooms import make_fused_q_trainer_crooms
from .fused_qlambda import make_fused_qlambda_trainer_rooms
from .fused_rocksample import make_fused_rocksample_rollout
from .fused_rooms import make_fused_rooms_rollout
from .fused_qlearning import (
    banks_to_q,
    make_fused_q_trainer,
    make_fused_q_trainer_msrooms,
    make_fused_q_trainer_rooms,
    q_to_banks,
)
from .fused_tag import make_fused_heavenhell_rollout, make_fused_tag_rollout
from .fused_taxi import make_fused_taxi_rollout, state_policy_table

__all__ = [
    "make_fused_taxi_rollout",
    "make_fused_rooms_rollout",
    "make_fused_rocksample_rollout",
    "make_fused_msrooms_rollout",
    "make_fused_crooms_rollout",
    "make_fused_tag_rollout",
    "make_fused_heavenhell_rollout",
    "state_policy_table",
    "make_fused_q_trainer",
    "make_fused_q_trainer_rooms",
    "make_fused_q_trainer_msrooms",
    "make_fused_ac_trainer_rooms",
    "make_fused_q_trainer_crooms",
    "make_fused_double_q_trainer",
    "make_fused_qlambda_trainer_rooms",
    "q_to_banks",
    "banks_to_q",
]
