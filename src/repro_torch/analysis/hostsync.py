"""Host-sync and purity audit (port of ``repro.analysis.hostsync``).

**Dynamic (transfer probe).**  A round is run by host Python, so
``transfer_probe`` patches every seam through which a tensor's value
reaches the host: ``Tensor.item`` / ``tolist`` / ``numpy`` /
``__array__`` / ``__float__`` / ``__int__`` / ``__bool__`` /
``__index__``, ``Tensor.cpu`` and ``Tensor.to`` to the CPU from another
device, and ``np.asarray`` / ``np.array`` on a tensor.  Two seams are
sanctioned and counted: ``common.device.to_host`` (the port's
``jax.device_get``) and ``HostMesh.gather_host``, the sharded runtime's
rank-consensus digest (one all-gather of 32 host bytes a round, which
refuses a drifted rank before its first collective; ``host-consensus``,
at most one a round).  Reads inside them are theirs.  Every patch is
undone on exit.  The contracts (the reference's):

  * ``ClientRuntime.run_round``: no read (``to_host`` none; the consensus
    at most once);
  * ``NeuLiteServer.run_round``: exactly one ``to_host`` (mean loss and
    cohort losses together) and nothing unsanctioned;
  * ``NeuLiteServer.evaluate``: exactly one ``to_host``.

On the card the probe also runs under ``torch.cuda.set_sync_debug_mode
("warn")``, which names every operation that makes the host wait for the
device, also those no Python seam shows (``nonzero``, boolean indexing,
a copy from pageable host memory); each is reported at the port's frame
that issued it (``hostsync.device-sync``).  The explicit syncs of a
capture (``torch.cuda.graph`` synchronizes and empties the cache before
it records, ``core/progressive.py``) and of ``empty_cache`` /
``synchronize`` move no value: ``hostsync.explicit-sync``, info.

**Static (purity pass).**  A torch program cannot be traced without
running, so ``purity_findings`` runs each spec's program once, eagerly,
under a ``TorchDispatchMode`` that sees every aten op (autograd's too) and
flags every op that writes float64 (``hostsync.f64-promotion``) and every
op that reads a value to the host (``aten::_local_scalar_dense``, a copy to
the CPU from another device: ``hostsync.callback``, the counterpart of a
host callback), each at the port's ``file:line``; the rank-consensus
gather's one read a run is its own (``hostsync.host-consensus`` past one).
A program that raises is ``hostsync.trace-failure``, not a crash.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
import traceback
import warnings
from typing import List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.abspath(__file__)
_SKIP = (os.sep + "torch" + os.sep, os.sep + "numpy" + os.sep,
         os.sep + "contextlib.py", os.sep + "warnings.py")

TENSOR_SEAMS = ("item", "tolist", "numpy", "__array__", "__float__",
                "__int__", "__bool__", "__index__")
SYNC_MESSAGE = "called a synchronizing CUDA operation"
EXPLICIT_SYNCS = ("synchronize", "empty_cache")   # torch.cuda's, called


def _short(path: str) -> str:
    path = os.path.abspath(path)
    if path.startswith(_PKG + os.sep):
        return os.path.relpath(path, _PKG)
    return os.path.basename(path)


def port_frame(stack=None) -> str:
    """``file:line`` of the innermost frame of the caller's code: not this
    module, torch, numpy or the standard library's context managers."""
    for frame in reversed(stack if stack is not None
                          else traceback.extract_stack()):
        fn = os.path.abspath(frame.filename)
        if fn == _SELF or any(s in fn for s in _SKIP):
            continue
        return f"{_short(fn)}:{frame.lineno}"
    return "<unknown>"


@dataclasses.dataclass
class SyncEvent:
    """One implicit device sync named by ``set_sync_debug_mode``."""
    location: str            # the port's file:line
    explicit: bool           # torch.cuda.synchronize / empty_cache / graph
    consensus: bool          # inside HostMesh.gather_host
    stack: tuple = ()        # innermost frames first, "file:line function"


class TransferProbe:
    """Device-to-host reads seen in a probed window."""

    def __init__(self):
        self.unsanctioned: List[str] = []    # "via @ file:line"
        self.to_host: List[str] = []         # common.device.to_host calls
        self.consensus: List[str] = []       # HostMesh.gather_host calls
        self.syncs: List[SyncEvent] = []     # the card's sync debug mode

    def record(self, via: str, into: list) -> None:
        into.append(f"{via} @ {port_frame()}")


def _tensor_seam(probe, local, name):
    orig = getattr(torch.Tensor, name)

    def wrapped(self, *a, **kw):
        if getattr(local, "depth", 0) == 0:
            probe.record(f"Tensor.{name}", probe.unsanctioned)
        local.depth = getattr(local, "depth", 0) + 1
        try:
            return orig(self, *a, **kw)
        finally:
            local.depth -= 1

    return orig, wrapped


def _device_move(probe, local, name):
    """``Tensor.cpu`` / ``Tensor.to``: a read where a tensor on another
    device comes to the CPU."""
    orig = getattr(torch.Tensor, name)

    def wrapped(self, *a, **kw):
        if name == "cpu":
            target = torch.device("cpu")
        else:
            target = torch._C._nn._parse_to(*a, **kw)[0]
        if (getattr(local, "depth", 0) == 0 and target is not None
                and target.type == "cpu" and self.device.type != "cpu"):
            probe.record(f"Tensor.{name}", probe.unsanctioned)
        local.depth = getattr(local, "depth", 0) + 1
        try:
            return orig(self, *a, **kw)
        finally:
            local.depth -= 1

    return orig, wrapped


def _np_seam(probe, local, fn):
    def wrapped(a, *args, **kw):
        if isinstance(a, torch.Tensor) and getattr(local, "depth", 0) == 0:
            probe.record(f"np.{fn.__name__}", probe.unsanctioned)
        local.depth = getattr(local, "depth", 0) + 1
        try:
            return fn(a, *args, **kw)
        finally:
            local.depth -= 1

    return wrapped


def _counted_seam(probe, local, fn, via, into):
    """A sanctioned seam: counted once a call, the reads inside it its
    own."""
    def wrapped(*args, **kw):
        if getattr(local, "depth", 0) == 0:
            probe.record(via, into)
        local.depth = getattr(local, "depth", 0) + 1
        try:
            return fn(*args, **kw)
        finally:
            local.depth -= 1

    return wrapped


@contextlib.contextmanager
def _patched_to_host(wrapped):
    """``to_host`` replaced in every loaded module that bound it (``from
    repro_torch.common.device import to_host`` binds a name of its own),
    restored on exit."""
    from repro_torch.common import device
    orig = device.to_host
    swapped = []
    for mod in list(sys.modules.values()):
        if getattr(mod, "to_host", None) is orig:
            setattr(mod, "to_host", wrapped)
            swapped.append(mod)
    try:
        yield
    finally:
        for mod in swapped:
            mod.to_host = orig


@contextlib.contextmanager
def transfer_probe():
    """Patch every device-to-host seam; yields a ``TransferProbe``."""
    from repro_torch.common import device
    from repro_torch.launch.mesh import HostMesh
    probe = TransferProbe()
    local = threading.local()
    saved = {}
    for name in TENSOR_SEAMS:
        saved[name], wrapped = _tensor_seam(probe, local, name)
        setattr(torch.Tensor, name, wrapped)
    for name in ("cpu", "to"):
        saved[name], wrapped = _device_move(probe, local, name)
        setattr(torch.Tensor, name, wrapped)
    np_saved = (np.asarray, np.array)
    np.asarray = _np_seam(probe, local, np.asarray)
    np.array = _np_seam(probe, local, np.array)
    gather = HostMesh.gather_host
    HostMesh.gather_host = _counted_seam(probe, local, gather,
                                         "HostMesh.gather_host",
                                         probe.consensus)
    try:
        with _patched_to_host(_counted_seam(probe, local, device.to_host,
                                            "to_host", probe.to_host)):
            yield probe
    finally:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)
        np.asarray, np.array = np_saved
        HostMesh.gather_host = gather


@contextlib.contextmanager
def sync_watch(probe: TransferProbe):
    """On the card: every implicit device sync in the window, named by
    ``torch.cuda.set_sync_debug_mode("warn")`` and recorded in
    ``probe.syncs`` at the port's frame.  Does nothing without a card."""
    if not torch.cuda.is_available():
        yield probe
        return
    prev = torch.cuda.get_sync_debug_mode()
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_MESSAGE not in str(message):
            return shown(message, category, filename, lineno, file, line)
        stack = traceback.extract_stack()[:-1]
        names = {(os.path.basename(f.filename), f.name) for f in stack}
        explicit = (any(f.name in EXPLICIT_SYNCS and os.sep + "cuda" + os.sep
                        in f.filename for f in stack)
                    or ("graphs.py", "__enter__") in names)
        probe.syncs.append(SyncEvent(
            location=port_frame(stack), explicit=explicit,
            consensus=any(f.name == "gather_host" for f in stack),
            stack=tuple(f"{_short(f.filename)}:{f.lineno} {f.name}"
                        for f in reversed(stack)
                        if not f.filename.endswith("warnings.py"))[:8]))

    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=f".*{SYNC_MESSAGE}")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield probe
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def report_events(probe: TransferProbe, report, *, program: str,
                  expect_gets: int, what: str,
                  max_consensus: int = 0) -> None:
    """The probe's events as findings: every unsanctioned read; more
    ``to_host`` calls than ``expect_gets``; more consensus gathers than
    ``max_consensus``; every implicit sync."""
    for entry in probe.unsanctioned:
        report.add(
            "hostsync.hidden-transfer",
            f"device->host read via {entry} inside {what}: batch it into "
            f"the round's single to_host (or keep the value on the "
            f"device).", program=program)
    if len(probe.to_host) > expect_gets:
        report.add(
            "hostsync.excess-sync",
            f"{len(probe.to_host)} to_host calls inside {what} (contract: "
            f"at most {expect_gets}): {probe.to_host}: batch them into "
            f"one.", program=program)
    if len(probe.consensus) > max_consensus:
        report.add(
            "hostsync.host-consensus",
            f"{len(probe.consensus)} rank-consensus gathers inside {what} "
            f"(at most {max_consensus}): {probe.consensus}",
            program=program)
    for ev in probe.syncs:
        if ev.explicit:
            report.add("hostsync.explicit-sync",
                       f"an explicit device sync inside {what} (a capture's "
                       f"synchronize / empty_cache): it moves no value",
                       severity="info", program=program,
                       location=ev.location)
        elif ev.consensus:
            continue    # the consensus gather's own, counted above
        else:
            report.add("hostsync.device-sync",
                       f"an implicit device sync inside {what}: the host "
                       f"waits for the device here (set_sync_debug_mode; "
                       f"stack {' <- '.join(ev.stack)})",
                       program=program, location=ev.location)


def audit_runtime_round(runtime, params, t, batchers, cohorts,
                        local_epochs, report) -> None:
    """``ClientRuntime.run_round`` reads nothing to the host and, on the
    card, makes no implicit sync; a mesh's consensus at most once."""
    with transfer_probe() as probe, sync_watch(probe):
        runtime.run_round(params, t, batchers, cohorts, local_epochs)
    report_events(probe, report, program=f"{runtime.name}.run_round",
                  expect_gets=0, what="ClientRuntime.run_round",
                  max_consensus=1)
    report.artifacts.setdefault("hostsync", {})[
        f"{runtime.name}.run_round"] = _summary(probe)


def audit_server_round(server, report) -> None:
    """One ``NeuLiteServer.run_round`` and one ``evaluate`` under the
    probe: exactly one ``to_host`` each."""
    test_batcher = server.test_batcher
    server.test_batcher = None      # evaluate is probed on its own below
    try:
        with transfer_probe() as probe:
            server.run_round(server.next_round)
    finally:
        server.test_batcher = test_batcher
    report_events(probe, report, program="NeuLiteServer.run_round",
                  expect_gets=1, what="NeuLiteServer.run_round",
                  max_consensus=1)
    arts = report.artifacts.setdefault("hostsync", {})
    arts["NeuLiteServer.run_round"] = _summary(probe)
    if test_batcher is None:
        return
    with transfer_probe() as probe:
        server.evaluate()
    report_events(probe, report, program="NeuLiteServer.evaluate",
                  expect_gets=1, what="NeuLiteServer.evaluate")
    arts["NeuLiteServer.evaluate"] = _summary(probe)


def _summary(probe: TransferProbe) -> dict:
    return {"unsanctioned": len(probe.unsanctioned),
            "to_host": len(probe.to_host),
            "consensus": len(probe.consensus),
            "implicit_syncs": sum(not (e.explicit or e.consensus)
                                  for e in probe.syncs),
            "explicit_syncs": sum(e.explicit for e in probe.syncs)}


# --------------------------------------------------------------------------- #
# the purity pass: one eager run under a dispatch mode
# --------------------------------------------------------------------------- #
_HOST_READ_OPS = ("aten::_local_scalar_dense",)
_COPY_OPS = ("aten::_to_copy", "aten::copy_", "aten::_copy_from")


class PurityMode(TorchDispatchMode):
    """Records every aten op that writes float64 or reads a value to the
    host, with the port's frame that issued it."""

    def __init__(self):
        super().__init__()
        self.f64: List[tuple] = []        # (op, shape, location)
        self.reads: List[tuple] = []      # (op, location)
        self.consensus: List[tuple] = []  # reads inside HostMesh.gather_host

    def _read(self, name):
        stack = traceback.extract_stack()
        into = (self.consensus if any(f.name == "gather_host" for f in stack)
                else self.reads)
        into.append((name, port_frame(stack)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if name in _HOST_READ_OPS or (
                name in _COPY_OPS and _to_cpu(name, args, kwargs, out)):
            self._read(name)
        for t in _tensors(out):
            if t.dtype == torch.float64:
                self.f64.append((name, tuple(t.shape), port_frame()))
                break
        return out


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return []


def _to_cpu(name, args, kwargs, out) -> bool:
    """Whether a copy op moved a tensor from another device to the CPU."""
    srcs = [a for a in args if isinstance(a, torch.Tensor)]
    if name == "aten::copy_":
        dst, src = args[0], args[1]
        return dst.device.type == "cpu" and src.device.type != "cpu"
    dst = _tensors(out)
    return bool(srcs and dst and srcs[0].device.type != "cpu"
                and dst[0].device.type == "cpu")


def purity_findings(spec, report) -> None:
    """Run ``spec`` once under the dispatch mode; report its float64 ops
    and host reads (or the exception it raised)."""
    mode = PurityMode()
    try:
        with mode:
            spec.run()
    except Exception as e:
        report.add(
            "hostsync.trace-failure",
            f"program failed to run: {type(e).__name__}: {e}",
            program=spec.name)
        return
    report_purity(mode, spec, report)


def report_purity(mode: PurityMode, spec, report) -> None:
    """What ``mode`` saw of a run of ``spec``, as findings."""
    if len(mode.consensus) > 1:
        report.add(
            "hostsync.host-consensus",
            f"{len(mode.consensus)} reads inside the rank-consensus gather "
            f"(HostMesh.gather_host) in one run of the program (at most "
            f"one): {mode.consensus}", program=spec.name)
    for op, loc in dict.fromkeys(mode.reads):
        report.add(
            "hostsync.callback",
            f"'{op}' reads a value to the host inside the program: the hot "
            f"path must stay on the device; move the read to the server's "
            f"to_host or delete it.",
            program=spec.name, location=loc)
    for op, shape, loc in dict.fromkeys(mode.f64):
        report.add(
            "hostsync.f64-promotion",
            f"'{op}' produces float64 {shape}: a silent f64 promotion "
            f"doubles bytes and falls off the fast path; cast the operand "
            f"(usually a float64 numpy array) to float32.",
            program=spec.name, location=loc)
