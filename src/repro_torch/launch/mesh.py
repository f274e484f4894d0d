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

``make_production_mesh`` lays out the reference's production meshes,
(data=16, model=16) and (pod=2, data=16, model=16), over a fake process
group (``FakeStore``, backend ``"fake"``): every collective on it returns
at once and moves nothing, and nothing is set up on a card.  The dry-run
(``launch.dryrun``) runs rank 0's program of such a mesh on fake tensors
and records the collectives it issues.

The roofline constants are an NVIDIA H100 SXM's (the hopper-kernels
guide, NVIDIA's H100 SXM data sheet): bf16 dense peak, HBM3 rate and
size, NVLink 4 to the other 7 cards of a DGX H100 host, and one 400 Gb/s
ConnectX-7 port per card between hosts.  A host is 8 consecutive ranks;
``link_bw`` gives a collective over a group of ranks the NVLink rate when
the group stays inside one host and the network's otherwise.
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

# Hardware constants for the roofline (NVIDIA H100 SXM, per card):
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                  # HBM3 bytes/s
HBM_BYTES = 80e9                  # HBM3 capacity, "80GB"
NVLINK_BW = 450e9                 # bytes/s each way, to the host's 7 others
NET_BW = 50e9                     # bytes/s each way: one 400 Gb/s port
HOST_RANKS = 8                    # cards (consecutive ranks) of one host

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def link_bw(ranks) -> float:
    """Bytes/s each way of a collective over ``ranks``: NVLink inside one
    host, the network across hosts."""
    hosts = {r // HOST_RANKS for r in ranks}
    return NVLINK_BW if len(hosts) <= 1 else NET_BW


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
    """A ``DeviceMesh`` over the world (``(data, model)``, or the
    production mesh's ``(pod, data, model)``) and the collectives the
    runtimes run on it.  ``shape`` maps each axis to its size and
    ``axis_names`` lists them, both read from the device mesh (``(data,
    model)`` where it names none), as the
    reference's ``Mesh`` gives them (what ``launch.sharding`` reads);
    ``index(axis)`` is this rank's place along an axis and ``grid`` the
    ranks' layout.  A collective's ``axis`` is a name or a tuple of names
    (the ranks that share every other coordinate, e.g. ``("pod",
    "data")``)."""

    def __init__(self, device_mesh, device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.device = device
        self.backend = backend
        self.axis_names = tuple(getattr(device_mesh, "mesh_dim_names", None)
                                or AXES)
        self.shape: Dict[str, int] = {a: device_mesh.size(i) for i, a in
                                      enumerate(self.axis_names)}
        self.rank = dist.get_rank()
        # read now: inside a fake mode the device mesh's tensor is fake
        ranks = getattr(device_mesh, "mesh", None)
        self.grid = (np.asarray(ranks.tolist()) if ranks is not None else
                     np.arange(self.size).reshape(tuple(self.shape.values())))
        self._index = {a: device_mesh.get_local_rank(a)
                       for a in self.axis_names}
        self._groups = {a: device_mesh.get_group(a)
                        for a in self.axis_names}

    def __repr__(self):
        return (f"HostMesh(shape={self.shape}, backend={self.backend!r}, "
                f"device={self.device})")

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def index(self, axis: str) -> int:
        return self._index[axis]

    def group(self, axis):
        """The process group of this rank along ``axis`` (a name or a
        tuple of names).  A tuple's groups are made on first use, every
        one of them, as ``new_group`` asks of every rank."""
        key = axis if isinstance(axis, str) else tuple(axis)
        if len(key) == 1 and not isinstance(key, str):
            key = key[0]
        if key not in self._groups:
            grid = self.grid
            along = [self.axis_names.index(a) for a in key]
            rest = [i for i in range(grid.ndim) if i not in along]
            lines = np.transpose(grid, rest + along).reshape(
                -1, int(np.prod([grid.shape[i] for i in along])))
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self._groups[key] = g
        return self._groups[key]

    def all_reduce(self, tensor: torch.Tensor, axis) -> torch.Tensor:
        """Sum ``tensor`` over ``axis`` in place (over one rank too: the
        same collective at every size); returns it."""
        dist.all_reduce(tensor, group=self.group(axis))
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
        dist.all_gather(parts, src, group=self.group(axis))
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


def production_shape(multi_pod: bool = False, world=None):
    """(shape, axis names) of the production mesh, or of a smaller one of
    the same axes: ``world`` a tuple of sizes, one per axis."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    if world is not None:
        world = tuple(int(n) for n in world)
        if len(world) != len(axes):
            raise ValueError(f"world {world} does not name one size per "
                             f"axis of {axes}")
        shape = world
    return shape, axes


def make_production_mesh(multi_pod: bool = False, world=None) -> HostMesh:
    """The production mesh, (data=16, model=16) or (pod=2, data=16,
    model=16) (``world``: a smaller one of the same axes), as a
    ``HostMesh`` over a fake process group in which this process is rank
    0: collectives on it record and move nothing, and no card is touched.
    A fake default group of another size is replaced; a real one raises
    (its collectives would run)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = production_shape(multi_pod, world)
    n = int(np.prod(shape))
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group is running: the "
                f"production mesh needs a fake one (run it in a process "
                f"of its own)")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    mesh = HostMesh(init_device_mesh("cpu", shape, mesh_dim_names=axes),
                    torch.device("cpu"), "fake")
    if "pod" in axes:
        mesh.group(("pod", "data"))     # the batch axes' groups, made now
    return mesh


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
