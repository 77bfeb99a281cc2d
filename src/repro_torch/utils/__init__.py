"""Helpers of the port: trees of tensors (``tree``), logging (``log``), the
clocks (``clock``), shapes and the stage schedule (``shapes``,
``schedule``), and the collective ledger (``collectives``, the counterpart
of ``src/repro/utils/hlo.py``: the port counts its collectives where it
issues them instead of reading them out of lowered HLO).
"""

from repro_torch.utils.clock import Clock, FakeClock, MonotonicClock
from repro_torch.utils.log import get_logger
from repro_torch.utils.shapes import next_pow2
from repro_torch.utils.tree import param_bytes, param_count, tree_flatten_with_names
