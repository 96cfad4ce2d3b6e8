"""What a metric's reader sees of a run: the host-clock window, the
set-up, the cell's data and, in a traced run, the reduced trace."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from gkmbench import yardstick
from gkmbench.data_types import Data
from gkmbench.harness import Cell, Window
from gkmbench.trace import TraceView


@dataclass
class RunView:
    cell: Cell
    data: Data
    setup_s: float
    window: Window
    trace: Optional[TraceView]

    @property
    def approx(self) -> bool:
        return bool(self.cell.traffic.get("construct", {}).get("approx", False))

    @property
    def jobs(self) -> int:
        return len(self.window.jobs)

    def count_work(self):
        """(int8 operations, bytes) of the cell's exact count matrix."""
        g = self.cell.config["g"]
        return yardstick.count_work(self.data.windows(g), g, self.data.alpha, self.data.n)

    def count_bound_s(self) -> float:
        g = self.cell.config["g"]
        return yardstick.count_bound_s(self.data.windows(g), g, self.data.alpha, self.data.n)
