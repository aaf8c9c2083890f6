"""Utilities of the port: phase timers (``utils/timing.py``), the JSON-lines
metrics sink (``utils/metrics.py``) and checkpoints
(``utils/checkpoint.py``)."""

from .metrics import MetricsSink
from .timing import PhaseTimer

__all__ = ["MetricsSink", "PhaseTimer"]
