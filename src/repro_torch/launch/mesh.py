"""Host meshes of ``torch.distributed`` ranks (port of ``make_host_mesh``
of ``repro.launch.mesh``).

Every rank runs the same program (SPMD).  ``make_host_mesh`` lays the
world out as a ``(data, model)`` ``DeviceMesh``: the cohort axis of a round
splits over ``"data"``, parameter shards over ``"model"``.  With no process
group and one rank wanted it starts a one-rank group itself (a
``FileStore`` in a temporary directory; NCCL on the card, gloo on the CPU),
destroyed at exit, so that ``FLConfig(runtime="sharded")`` runs on one card
as the reference's runs on one device.

``spawn_world(fn, world, device, *args)`` runs ``fn(device, *args)`` in
``world`` processes (``torch.multiprocessing`` spawn, every rank
initialised from a ``FileStore``) and returns each rank's result; under a
``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) it runs
``fn`` in this process as that rank.  The backend is chosen once, from the
layout: NCCL where each rank has a card of its own, gloo where ranks share
one (NCCL refuses two ranks on one device) and on the CPU; the choice is
printed.  gloo takes the three collectives the runtimes run (all-reduce,
all-gather, broadcast) on CUDA tensors as they are (PyTorch 2.11 on the
H100), so no collective is copied through host memory.

The reference's production mesh (a TPU pod) and its roofline constants
are not ported.
"""
from __future__ import annotations

import atexit
import os
import pickle
import shutil
import tempfile
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.device import DeviceLike, resolve_device

AXES = ("data", "model")
WORLD_TIMEOUT_S = 900


def host_mesh_shape(n: int, model_parallel: int = 1) -> Tuple[int, int]:
    """``(data, model)`` for ``n`` ranks, the reference's clamping:
    ``model_parallel`` is clamped to the largest divisor of ``n`` that does
    not exceed the request (a non-divisor request would drop ranks), with a
    warning."""
    req = max(1, int(model_parallel))
    mp = min(req, n)
    if n % mp:
        mp = max(d for d in range(1, mp + 1) if n % d == 0)
    if mp != req:
        warnings.warn(f"model_parallel={model_parallel} does not fit the "
                      f"{n}-rank world; clamping to {mp}", stacklevel=2)
    return n // mp, mp


def choose_backend(device: torch.device, ranks_per_host: int) -> str:
    """NCCL where every rank of a host has a card of its own, else gloo."""
    if device.type == "cuda" and ranks_per_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


class HostMesh:
    """A ``(data, model)`` ``DeviceMesh`` over the world and the
    collectives the runtimes run on it.  ``shape`` maps each axis to its
    size and ``axis_names`` lists them, as the reference's ``Mesh`` does
    (what ``launch.sharding`` reads); ``index(axis)`` is this rank's place
    along an axis."""

    axis_names = AXES

    def __init__(self, device_mesh, device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.device = device
        self.backend = backend
        self.shape: Dict[str, int] = {a: device_mesh.size(i)
                                      for i, a in enumerate(AXES)}
        self.rank = dist.get_rank()
        self._index = {a: device_mesh.get_local_rank(a) for a in AXES}
        self._groups = {a: device_mesh.get_group(a) for a in AXES}

    def __repr__(self):
        return (f"HostMesh(shape={self.shape}, backend={self.backend!r}, "
                f"device={self.device})")

    def index(self, axis: str) -> int:
        return self._index[axis]

    def all_reduce(self, tensor: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``tensor`` over ``axis`` in place (over one rank too: the
        same collective at every size); returns it."""
        dist.all_reduce(tensor, group=self._groups[axis])
        return tensor

    def all_gather(self, tensor: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        """Every rank's ``tensor`` along ``axis``, concatenated on ``dim``
        in the axis's order."""
        n = self.shape[axis]
        if n == 1:
            return tensor
        src = tensor.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self._groups[axis])
        return torch.cat(parts, dim)

    def gather_host(self, values: np.ndarray) -> np.ndarray:
        """Every rank's int64 ``values`` (the same length on every rank),
        stacked in rank order on every rank, as a numpy array; through the
        card for NCCL, host memory for gloo."""
        where = self.device if self.backend == "nccl" else "cpu"
        t = torch.from_numpy(np.asarray(values, np.int64).copy()).to(where)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        return torch.stack(parts).cpu().numpy()

    def barrier(self) -> None:
        if dist.get_world_size() > 1:
            dist.barrier()


def _one_rank_group(device: torch.device) -> None:
    """A one-rank default group from a ``FileStore`` in a temporary
    directory, destroyed (and the directory removed) at exit."""
    tmp = tempfile.mkdtemp(prefix="neulite-mesh-")
    backend = choose_backend(device, 1)
    dist.init_process_group(backend,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 1),
                            rank=0, world_size=1)

    def close():
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(close)


def make_host_mesh(model_parallel: int = 1,
                   device: DeviceLike = None) -> HostMesh:
    """A ``(data, model)`` mesh over the world's ranks
    (``host_mesh_shape``), on ``device`` (the current card by default;
    ``"cpu"`` for gloo on the host).  Starts a one-rank group where none
    exists."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        _one_rank_group(dev)
    from torch.distributed.device_mesh import init_device_mesh
    shape = host_mesh_shape(dist.get_world_size(), model_parallel)
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=AXES)
    return HostMesh(dm, dev, dist.get_backend())


# --------------------------------------------------------------------------- #
# worlds of processes
# --------------------------------------------------------------------------- #
def init_rank(rank: int, world: int, device: DeviceLike,
              store_path: str) -> torch.device:
    """Join a world of ``world`` ranks on this host as ``rank`` through a
    ``FileStore`` at ``store_path`` (NCCL or gloo by the layout,
    ``choose_backend``; rank 0 prints the choice); on the card the current
    device is ``rank % device_count``.  Returns this rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = choose_backend(dev, world)
    if rank == 0:
        print(f"world of {world} on {dev.type}: backend {backend}",
              flush=True)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    return dev


def _rank_main(rank: int, world: int, device: str, tmp: str, queue,
               threads: Optional[int]):
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        dev = init_rank(rank, world, device, os.path.join(tmp, "store"))
        out = fn(dev, *args)
        queue.put((rank, "ok", out))
    except BaseException:           # reported to the parent, re-raised
        import traceback
        queue.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _torchrun_rank() -> Optional[Tuple[int, int, int]]:
    env = os.environ
    if all(k in env for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")):
        return (int(env["RANK"]), int(env["WORLD_SIZE"]),
                int(env["LOCAL_RANK"]))
    return None


class World:
    """Ranks started by ``start_world``: ``join`` collects their results
    (in rank order) and ends every process."""

    def __init__(self, procs, queue, tmp: str, timeout: float):
        self.procs, self.queue, self.tmp = procs, queue, tmp
        self.timeout = timeout

    def join(self) -> List[Any]:
        world = len(self.procs)
        try:
            results, errors = {}, {}
            for _ in range(world):
                rank, status, out = _get(self.queue, self.procs,
                                         self.timeout)
                (results if status == "ok" else errors)[rank] = out
                if errors:
                    break
            if errors:
                rank, tb = next(iter(errors.items()))
                raise RuntimeError(f"rank {rank} of {world} failed:\n{tb}")
            return [results[r] for r in range(world)]
        finally:
            for p in self.procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
            shutil.rmtree(self.tmp, ignore_errors=True)


def start_world(fn: Callable, world: int, device: DeviceLike, *args,
                threads: Optional[int] = None,
                timeout: float = WORLD_TIMEOUT_S) -> World:
    """Start ``fn(device, *args)`` on every rank of a world of ``world``
    spawned processes and return at once; ``World.join`` collects.  ``fn``
    must be importable (it is pickled by name) and its result picklable;
    ``device`` is resolved here, so that the card is asked for unless the
    caller passes ``"cpu"``.  ``threads`` sets each rank's torch
    threads."""
    dev = resolve_device(device)
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    tmp = tempfile.mkdtemp(prefix="neulite-world-")
    # the inputs go through a file, not the start pipe: a child reads the
    # pipe only after importing the main module, so a large argument
    # would start the ranks one after another
    with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
        pickle.dump((fn, args), f)
    procs = []
    for rank in range(world):
        p = ctx.Process(target=_rank_main, args=(
            rank, world, str(dev.type), tmp, queue, threads))
        p.start()
        procs.append(p)
    return World(procs, queue, tmp, timeout)


def spawn_world(fn: Callable, world: int, device: DeviceLike,
                *args, threads: Optional[int] = None,
                timeout: float = WORLD_TIMEOUT_S) -> List[Any]:
    """``fn(device, *args)`` on every rank of a world of ``world``
    processes (``start_world``, then ``join``); returns the ranks' results
    in rank order.  Under ``torchrun`` this process is one rank: ``fn``
    runs here and the list holds its result alone.  A rank that fails
    fails the call with its traceback; every process is joined before it
    returns."""
    dev = resolve_device(device)
    env = _torchrun_rank()
    if env is not None:
        rank, size, local = env
        if not dist.is_initialized():
            if dev.type == "cuda":
                torch.cuda.set_device(local % torch.cuda.device_count())
                dev = torch.device("cuda", torch.cuda.current_device())
            dist.init_process_group(choose_backend(
                dev, int(os.environ.get("LOCAL_WORLD_SIZE", size))))
        return [fn(dev, *args)]
    return start_world(fn, world, dev, *args, threads=threads,
                       timeout=timeout).join()


def _get(queue, procs, timeout: float):
    """The next rank's message; raises if every rank exits without one or
    ``timeout`` seconds pass."""
    import time
    end = time.monotonic() + timeout
    while True:
        if not queue.empty():
            return queue.get()
        if all(not p.is_alive() for p in procs) and queue.empty():
            codes = [p.exitcode for p in procs]
            raise RuntimeError(f"every rank exited without a result: exit "
                               f"codes {codes}")
        if time.monotonic() > end:
            raise TimeoutError(f"no rank reported within {timeout} s")
        time.sleep(0.01)
