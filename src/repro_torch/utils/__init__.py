"""Helpers of the port: trees of tensors (``tree``), logging (``log``), the
clocks (``clock``), shapes and the stage schedule (``shapes``,
``schedule``).

``src/repro/utils/hlo.py`` (reading XLA's lowered HLO) has no counterpart:
nothing in the port lowers to XLA, as ``launch/__init__`` says of the dry
run.
"""

from repro_torch.utils.clock import Clock, FakeClock, MonotonicClock
from repro_torch.utils.log import get_logger
from repro_torch.utils.shapes import next_pow2
from repro_torch.utils.tree import param_bytes, param_count, tree_flatten_with_names
