from .grid import (
    DIRECTIONS_2D,
    DIRECTIONS_3D,
    coord_to_flat,
    flat_to_coord,
    hansen_indices,
    surrounding_indices,
)
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .debug import assert_finite, checked
from .platform import compilation_cache_dir, enable_compilation_cache
from .profiling import Timer, annotate, steps_per_second, trace

__all__ = [
    "enable_compilation_cache",
    "compilation_cache_dir",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "steps_per_second",
    "trace",
    "annotate",
    "Timer",
    "checked",
    "assert_finite",
    "DIRECTIONS_2D",
    "DIRECTIONS_3D",
    "surrounding_indices",
    "hansen_indices",
    "flat_to_coord",
    "coord_to_flat",
]
