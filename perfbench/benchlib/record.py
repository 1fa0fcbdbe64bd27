"""What one run measured, as the metric readers see it."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .devtrace import Timeline


@dataclass
class Run:
    loop: str                          # the mix's loop: "partition" or "session"
    cell: str
    durations: List[float]             # host seconds of each call or update in the window
    window_s: float                    # host seconds of the window
    setup_s: float                     # process start to the first timed call
    memory_peak_bytes: int             # max_memory_allocated over the window
    series: Dict[str, List[float]] = field(default_factory=dict)   # per call or update
    spans: List[Tuple[str, float, float]] = field(default_factory=list)  # traced runs
    timeline: Optional[Timeline] = None                              # traced runs
    launches: List[Tuple[int, int, int]] = field(default_factory=list)  # (R, W, k)

    @property
    def calls(self) -> int:
        return len(self.durations)

    def span_seconds(self, prefix: str) -> Optional[float]:
        """Seconds of the spans whose name starts with ``prefix``, per call
        or update; ``None`` where none was recorded."""
        sel = [b - a for name, a, b in self.spans if name.startswith(prefix)]
        if not sel or not self.calls:
            return None
        return sum(sel) / self.calls
