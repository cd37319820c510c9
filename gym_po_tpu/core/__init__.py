from .env import Environment, EnvState, StepOut
from .pytree import PyTreeNode
from .spaces import Box, Discrete, Space, batch_space

__all__ = [
    "Environment",
    "EnvState",
    "StepOut",
    "PyTreeNode",
    "Space",
    "Discrete",
    "Box",
    "batch_space",
]
