"""Block partitioning: divide a model's unit list into T progressive blocks.

A *unit* is the smallest partitionable element — a scan period for
transformers (``ModelConfig.num_periods`` units) or a conv/residual unit for
CNNs.  A ``BlockPlan`` assigns contiguous unit ranges to blocks and records
how many trailing units of the previous block co-train with the current one
(the Training Harmonizer's L_{t-1} boundary set).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    num_units: int
    num_stages: int
    bounds: Tuple[Tuple[int, int], ...]   # [start, end) unit range per block
    boundary_units: int = 1               # |L_{t-1}| in units

    def stage_ranges(self, t: int):
        """Returns (frozen_range, boundary_range, active_range) for stage t."""
        start, end = self.bounds[t]
        nb = min(self.boundary_units, start) if t > 0 else 0
        return (0, start - nb), (start - nb, start), (start, end)

    @property
    def block_sizes(self):
        return [e - s for s, e in self.bounds]


def make_plan(num_units: int, num_stages: int,
              boundary_units: int = 1) -> BlockPlan:
    """Split ``num_units`` into ``num_stages`` near-equal contiguous blocks."""
    num_stages = max(1, min(num_stages, num_units))
    base, rem = divmod(num_units, num_stages)
    bounds, start = [], 0
    for t in range(num_stages):
        size = base + (1 if t < rem else 0)
        bounds.append((start, start + size))
        start += size
    assert start == num_units
    return BlockPlan(num_units=num_units, num_stages=num_stages,
                     bounds=tuple(bounds), boundary_units=boundary_units)


def unit_block_id(plan: BlockPlan, unit: int) -> int:
    for t, (s, e) in enumerate(plan.bounds):
        if s <= unit < e:
            return t
    raise ValueError(unit)
