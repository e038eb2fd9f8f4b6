"""Utilities: checkpointing, profiling/timing harness."""

from slamsim.utils.checkpoint import restore_state, save_state
from slamsim.utils.profiling import steps_per_second, timed, trace

__all__ = ["restore_state", "save_state", "steps_per_second", "timed",
           "trace"]
