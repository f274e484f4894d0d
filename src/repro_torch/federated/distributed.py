"""DEPRECATED shim — the pod-scale FL round moved into federated.runtime.

The vmapped round step and its dry-run specs now live on the unified
``ClientRuntime`` path (``VectorizedRuntime`` / ``ShardedRuntime``); this
module only re-exports the legacy names for older callers.
"""
from repro_torch.federated.runtime import (cohort_batches_specs,  # noqa: F401
                                           make_fl_round_step)

__all__ = ["make_fl_round_step", "cohort_batches_specs"]
