"""Data parallelism over devices with torch.distributed (counterpart of
vipnerf_tpu/parallel/mesh.py).

The reference's only parallelism is DataParallel over the GPUs that
`configs['device']` lists (src/Trainer01.py:517, Tester01.py:42): the ray
batch is scattered, the parameters replicated. The JAX package puts the
same policy on a 1-D mesh ("rays") under one controller. PyTorch has no
single controller, so the port runs one process per device, joined by
torch.distributed, and keeps the mesh's contract: the same math, sharded,
gives the same numbers as one device, up to the order of reductions.

- `select_devices`: `configs['device']` -> the devices, one rank each:
  "all"/None every visible GPU, an index or a list of indices those GPUs,
  "cpu" one CPU rank and a list of "cpu" entries that many CPU ranks (the
  counterpart of the JAX package's virtual CPU devices). A list may name
  one GPU twice: two ranks then share it.
- The backend follows from the devices: NCCL for distinct GPUs, gloo for
  CPU ranks and for ranks that share a GPU (NCCL refuses two ranks on one
  device). Both run every collective here (all_reduce, all_gather and
  barrier) on the tensors of either device, so both run the same code.
- `RayGroup`: this rank's view of the default process group: its rank,
  the world size, its device, contiguous shard bounds (as P("rays") splits
  an axis), `all_reduce_sum`, `gather` and `barrier`.
- `StepShard`: this rank's part of a training step, which
  `train.step.make_train_step` reads: its sub-batches and, for each, the
  rows of its rays among the global sub-batch's, with which a
  `ShardGenerator` draws that sub-batch's per-ray randoms. `ray_shard`
  shards the ray axis (the `Trainer`): each global sub-batch of
  `sub_batch_size` rays (the whole batch without one) is cut by stream and
  each piece split over the ranks, so the ranks' i-th sub-batches together
  are one process's i-th sub-batch. `scene_shard` shards the scene axis
  (the `MultiSceneTrainer`).
- `ShardGenerator`: a torch.Generator that makes a rank draw the whole
  (sub-)batch's per-ray randoms and keep its rows
  (`core.sampling.ray_draw`), so that a sharded step draws what one process
  draws. The step alone sets its rows, before each sub-batch.
- `run_on_devices(fn, configs[, device_sel])`: runs `fn(configs)` on the
  selected devices. A process in an initialised default group, or one launched by
  torchrun (RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT in its
  environment), joins that group; with one device `fn` runs here; with
  several, the libraries under csrc/ are built here first and one process
  per device is spawned (the ranks only load them). Rank 0's result comes
  back.
"""

import os
import socket
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vipnerf_tpu_torch.kernels import build
from vipnerf_tpu_torch.utils import tracing


def _cuda_missing(device_sel) -> RuntimeError:
    return RuntimeError(f"device {device_sel!r} asks for CUDA, which is not available; "
                        'pass device "cpu" to run on the CPU')


def select_devices(device_sel: Any = None) -> List[torch.device]:
    """Resolve a ``configs['device']`` selection to the devices of the
    ranks, in rank order (vipnerf_tpu/parallel/mesh.py `select_devices`,
    whose errors it keeps: an index out of range raises ValueError). A GPU
    selection without CUDA raises RuntimeError: nothing falls back to the
    CPU quietly."""
    if device_sel == "cpu":
        return [torch.device("cpu")]
    if device_sel is None or device_sel == "all":
        if not torch.cuda.is_available():
            raise _cuda_missing(device_sel)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if isinstance(device_sel, int):
        device_sel = [device_sel]
    if not isinstance(device_sel, (list, tuple)) or not device_sel:
        raise ValueError(f"unrecognized device selection: {device_sel!r}")
    cpus = [d for d in device_sel if d == "cpu"]
    if cpus:
        if len(cpus) != len(device_sel):
            raise ValueError(f"device {device_sel!r}: CPU and GPU ranks cannot be mixed")
        return [torch.device("cpu")] * len(cpus)
    if not torch.cuda.is_available():
        raise _cuda_missing(device_sel)
    count = torch.cuda.device_count()
    bad = [i for i in device_sel if not 0 <= int(i) < count]
    if bad:
        raise ValueError(f"configs['device'] indices {bad} out of range: {count} local device(s) present")
    return [torch.device("cuda", int(i)) for i in device_sel]


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL for distinct GPUs; gloo for CPU ranks or a GPU shared by ranks."""
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


class RayGroup:
    """This rank of the default process group, on its selected device."""

    def __init__(self, devices: Sequence[torch.device]):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        local = int(os.environ.get("LOCAL_RANK", self.rank))
        if local >= len(devices):
            raise ValueError(f"rank {self.rank} (local {local}) of {self.world} has no device: "
                             f"the selection holds {len(devices)}")
        self.device = devices[local]
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone writes the run tree."""
        return self.rank == 0

    def shard(self, n: int) -> slice:
        """This rank's contiguous share of an axis of n (n % world == 0)."""
        if n % self.world:
            raise ValueError(f"an axis of {n} does not shard over {self.world} ranks")
        m = n // self.world
        return slice(self.rank * m, (self.rank + 1) * m)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns it."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's (m, ...) `t` along axis 0, in rank order, on every rank."""
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    def barrier(self):
        """Every rank waits here for every other."""
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def current_group(device_sel: Any) -> Optional[RayGroup]:
    """The RayGroup of this process when it belongs to an initialised
    default group (a spawned or joined rank), else None."""
    if not dist.is_initialized():
        return None
    return RayGroup(select_devices(device_sel))


class StepShard:
    """This rank's part of a training step (see the module docstring):
    `group`, the group whose ranks share the ray axis (None where the
    scenes are sharded: the step then needs no collective);
    `sub_batch_size`, the rays per scene of each of this rank's sub-batches
    (None: the step is one batch); `draws[i]`, (the rows of this rank's rays
    among global sub-batch i's, that sub-batch's ray count); `columns`,
    this rank's columns of each stream's index block (the ray axis)."""

    def __init__(self, group: Optional["RayGroup"], sub_batch_size: Optional[int],
                 draws: List[Tuple[torch.Tensor, int]], columns: Optional[List[np.ndarray]] = None):
        self.group, self.sub_batch_size, self.draws, self.columns = group, sub_batch_size, draws, columns


def ray_shard(group: RayGroup, streams: Sequence[int], sub_batch_size: Optional[int] = None) -> Optional[StepShard]:
    """The ray axis of a step whose batch is `streams` laid end to end
    (nerf rays, then sparse-depth rays): global sub-batch i holds rays
    [i * size, (i + 1) * size) of the batch (size = `sub_batch_size`, or
    the whole batch); each stream's piece of it is split over the ranks in
    contiguous shares. None when a piece does not divide by the world size:
    then every rank computes the whole batch."""
    total = sum(streams)
    size = sub_batch_size or total
    if total % size:
        raise ValueError(f"sub_batch_size {size} does not divide the batch of {total} rays")
    pieces = []  # (sub-batch start, stream, stream start, piece start, piece stop), in batch positions
    for lo in range(0, total, size):
        offset = 0
        for s, n in enumerate(streams):
            a, b = max(lo, offset), min(lo + size, offset + n)
            if a < b:
                pieces.append((lo, s, offset, a, b))
            offset += n
    if any((b - a) % group.world for *_, a, b in pieces):
        return None
    rows: Dict[int, List[np.ndarray]] = {lo: [] for lo in range(0, total, size)}
    columns: List[List[np.ndarray]] = [[] for _ in streams]
    for lo, s, offset, a, b in pieces:
        m = (b - a) // group.world
        start = a + group.rank * m
        rows[lo].append(np.arange(start - lo, start - lo + m))
        columns[s].append(np.arange(start - offset, start - offset + m))
    draws = [(torch.from_numpy(np.concatenate(r)).to(group.device), size) for r in rows.values()]
    return StepShard(group, None if sub_batch_size is None else size // group.world, draws,
                     [np.concatenate(c) for c in columns])


def scene_shard(group: RayGroup, scenes: int, rays_per_scene: int,
                sub_batch_size: Optional[int] = None) -> StepShard:
    """The scene axis: this rank's `group.shard(scenes)`, each sub-batch
    (of `sub_batch_size` rays per scene, or the whole batch) drawn as the
    S scenes' sub-batch of one process, scene-major."""
    local = group.shard(scenes)
    size = sub_batch_size or rays_per_scene
    rows = torch.arange(local.start * size, local.stop * size, device=group.device)
    return StepShard(None, sub_batch_size, [(rows, scenes * size)] * (rays_per_scene // size))


class ShardGenerator(torch.Generator):
    """A generator whose per-ray draws are the whole (sub-)batch's: with
    `ray_rows` set (this rank's positions in a (sub-)batch of `ray_total`
    rays), `core.sampling.ray_draw` draws for all `ray_total` rays and
    keeps those rows, so every rank's randoms are the ones one process
    draws. The training step sets them (`StepShard.draws`)."""

    def __new__(cls, device: Any = "cpu"):
        return super().__new__(cls, device)

    def __init__(self, device: Any = "cpu"):
        self.ray_rows: Optional[torch.Tensor] = None
        self.ray_total = 0

    def shard(self, rows: Optional[torch.Tensor], total: int = 0):
        self.ray_rows, self.ray_total = rows, total


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _rank_main(rank: int, world: int, address: str, backend: str, threads: int,
               fn: Callable, configs: Dict[str, Any], queue) -> None:
    """A spawned rank: join the group, run `fn`, send rank 0's result and
    its tracer's snapshot."""
    torch.set_num_threads(threads)
    build.forbid_builds()
    dist.init_process_group(backend, init_method=address, rank=rank, world_size=world)
    try:
        result = fn(configs)
        if rank == 0:
            queue.put((result, tracing.snapshot()))
    finally:
        dist.destroy_process_group()


def run_on_devices(fn: Callable[[Dict[str, Any]], Any], configs: Dict[str, Any], device_sel: Any = None) -> Any:
    """`fn(configs)` on the devices `device_sel` selects (by default
    `configs['device']`; see the module docstring); returns rank 0's
    result. Spawned ranks' spans and counters stay in their processes,
    except rank 0's, which are merged into this process's tracer."""
    if device_sel is None:
        device_sel = configs.get("device", "all")
    if dist.is_initialized():
        return fn(configs)
    if all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group(backend_for(select_devices(device_sel)), init_method="env://")
        try:
            return fn(configs)
        finally:
            dist.destroy_process_group()
    devices = select_devices(device_sel)
    if len(devices) == 1:
        return fn(configs)
    build.build_all(None if devices[0].type == "cuda" else ["raystream"])
    world = len(devices)
    threads = max(1, torch.get_num_threads() // world) if devices[0].type == "cpu" else torch.get_num_threads()
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = torch.multiprocessing.start_processes(
        _rank_main, args=(world, f"tcp://127.0.0.1:{_free_port()}", backend_for(devices), threads, fn,
                          configs, queue),
        nprocs=world, join=False, start_method="spawn")
    results = []
    while not procs.join(timeout=0.2):  # raises, with the rank's traceback, if a rank fails
        while not queue.empty():  # drained while the ranks run: a large result blocks its writer
            results.append(queue.get())
    while not queue.empty():
        results.append(queue.get())
    result, snapshot = results[0]
    tracing.merge(snapshot)
    return result
