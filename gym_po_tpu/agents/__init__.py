from .networks import ActorCritic, make_actor_critic
from .qlearning import (
    QConfig,
    fused_actor_critic,
    fused_q_learning,
    greedy_policy,
    q_learning,
)
from .ppo_rnn import (
    RecurrentActorCritic,
    RNNTrainState,
    init_rnn_state,
    make_rnn_train_step,
    shard_rnn_state,
)
from .ppo import (
    PPOConfig,
    TrainState,
    init_train_state,
    make_chunked_train_step,
    make_multi_train_step,
    make_train_step,
    shard_train_state,
    train,
)

__all__ = [
    "ActorCritic",
    "make_actor_critic",
    "PPOConfig",
    "TrainState",
    "init_train_state",
    "make_train_step",
    "make_multi_train_step",
    "make_chunked_train_step",
    "shard_train_state",
    "train",
    "RecurrentActorCritic",
    "RNNTrainState",
    "init_rnn_state",
    "make_rnn_train_step",
    "shard_rnn_state",
    "QConfig",
    "fused_q_learning",
    "fused_actor_critic",
    "q_learning",
    "greedy_policy",
]
