"""Utilities of the port (``utils/timing.py``: phase timers)."""

from .timing import PhaseTimer

__all__ = ["PhaseTimer"]
