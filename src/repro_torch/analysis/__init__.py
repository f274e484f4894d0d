"""The port's auditors (port of ``repro.analysis``): checks that turn the
port's claims into findings.

  hostsync     a ``ClientRuntime.run_round`` reads nothing to the host; a
               server round and an evaluation read it once each
               (``common.device.to_host``); on the card every implicit
               device sync is named by ``torch.cuda.set_sync_debug_mode``;
               a program writes no float64 and reads no value to the host
               (a dispatch mode over one eager run).
  collectives  nothing but the Eq. 1 all-reduce crosses the ``data`` axis
               of a mesh of ranks, nothing crosses it in local training,
               and the rank-consensus gather runs at most once a round.
  donation     a step leaves none of its threaded state held twice.
  memory       every stage's allocator peak below the full-model step's;
               at ``model_parallel >= 2`` a rank holds at most 0.55 of the
               trainable bytes.
  kernel_audit the CUDA kernels against their plain versions on the
               reference's adversarial draws, and each built kernel's
               registers, shared memory and spills.
  contracts    ``tools/check_contracts.py``'s rules on the port's tree.

Programs come from each runtime's ``trace_specs`` / ``full_reference_spec``
(``federated/runtime.py``).  Run it with ``python -m repro_torch.analysis``
(``--help``); it runs on the card unless given ``--device cpu``.
"""
from repro_torch.analysis.report import Finding, Report

__all__ = ["Finding", "Report"]
