"""Data parallelism over cards (counterpart of nerfmeshes_tpu/parallel/mesh.py).

The JAX package shards the ray axis over a 1-D `data` mesh with
replicated parameters, inside shard_map programs whose bodies make their
own collectives (pmean of grads and metrics, psum of BuFF's voxel
accumulators). Here the same split runs in PyTorch's idiom: one process
per card (a rank of a `DataGroup`), every rank holding the whole model,
optimizer state, dataset and BuFF tree, and only the ray axis split. The
step bodies call the collectives below themselves: nothing is wrapped in
DistributedDataParallel, and nothing reduces behind the caller's back.

Only `all_reduce` and `broadcast` are used, the two collectives that
torch.distributed's gloo backend offers for CUDA tensors as well as NCCL.
Per-ray outputs are gathered by summing a zero-filled buffer in which each
rank wrote its own rows: adding zeros is exact, so the sum is the gather.

A one-rank group runs the unsharded code path unless it is `force`d,
which builds the sharded path (and its collectives) on a one-rank process
group, as JAX's `force_shard` does on a size-1 mesh.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from nerfmeshes_tpu_torch.device import resolve_device

DATA_AXIS = "data"


@dataclass
class DataGroup:
    """This process's place in a data-parallel group: its rank, the world
    size, the device it runs on, the torch.distributed backend, and
    whether a one-rank group takes the sharded path anyway (`force`)."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    force: bool = False

    @property
    def sharded(self) -> bool:
        """Whether the step bodies split the rays and call collectives."""
        return self.world > 1 or self.force

    @property
    def is_main(self) -> bool:
        """Rank 0 alone writes files and prints."""
        return self.rank == 0

    def local_rows(self, n: int) -> slice:
        """This rank's rows of an `n`-row batch split in rank order."""
        if n % self.world:
            raise ValueError(f"chunk {n} must be divisible by the mesh size {self.world}")
        local = n // self.world
        return slice(self.rank * local, (self.rank + 1) * local)

    def barrier(self) -> None:
        """Wait on the host for every rank (after rank 0 writes a file)."""
        if self.sharded:
            dist.barrier()


def single(device=None) -> DataGroup:
    """The one-rank group on `device` (None: the CUDA card)."""
    return DataGroup(device=resolve_device(device))


def _backend_for(device: torch.device, backend: Optional[str]) -> str:
    return backend or ("nccl" if device.type == "cuda" else "gloo")


def _select(device) -> torch.device:
    """`device` with its card's index, made the current card."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return device


def init_group(rank: int, world: int, device, *, backend: Optional[str] = None,
               init_method: str = "env://", force: bool = False) -> DataGroup:
    """Join the default process group as `rank` of `world` on `device`."""
    device = _select(device)
    backend = _backend_for(device, backend)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return DataGroup(rank=rank, world=world, device=device, backend=backend, force=force)


def forced(device=None, backend: Optional[str] = None) -> DataGroup:
    """A one-rank process group whose step bodies take the sharded path,
    collectives included (JAX's force_shard on a size-1 mesh)."""
    device = _select(resolve_device(device))
    backend = _backend_for(device, backend)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return DataGroup(device=device, backend=backend, force=True)


def from_env(device=None) -> Optional[DataGroup]:
    """The group a `torchrun` launch describes (WORLD_SIZE, RANK,
    LOCAL_RANK, MASTER_ADDR/PORT), joined; None outside torchrun. Rank r
    runs on cuda:LOCAL_RANK under NCCL (`device` None or "cuda"), or with
    `device` "cpu" on the host under gloo. A card's index in `device`
    raises in a world above 1: every rank would take that one card."""
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    elif dev.type == "cuda" and world > 1:
        raise ValueError(
            f"device {dev} under a torchrun world of {world}: NCCL takes one rank per card, "
            "so rank r runs on cuda:LOCAL_RANK; pass --device cuda (or none)")
    if world == 1:
        return DataGroup(device=resolve_device(dev))
    return init_group(rank, world, dev)


def default_world() -> int:
    """Every visible card (JAX's default_mesh); 1 on a host without one."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def round_chunk(chunk: int, devices: int = 1) -> int:
    """Smallest chunk >= `chunk` divisible by the device count."""
    return max(devices, -(-int(chunk) // devices) * devices)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_rank(rank: int, fn: Callable, world: int, device, backend: Optional[str], port: int,
              args: tuple) -> None:
    dev = torch.device("cuda", rank) if device is None else torch.device(device)
    group = init_group(rank, world, dev, backend=backend,
                       init_method=f"tcp://localhost:{port}")
    fn(group, *args)
    dist.destroy_process_group()


def launch(fn: Callable, world_size: int, device=None, *, backend: Optional[str] = None,
           args: Sequence = ()) -> None:
    """Run fn(group, *args) on `world_size` processes, started with
    torch.multiprocessing's `spawn`, and wait for them. Rank r runs on
    cuda:r under NCCL, or every rank on `device` when one is given ("cpu":
    the host, under gloo). `fn` must be importable by name. A rank that
    raises brings the others down, and the error is raised here."""
    import torch.multiprocessing as mp

    mp.start_processes(_run_rank, args=(fn, world_size, device, backend, _free_port(),
                                        tuple(args)),
                       nprocs=world_size, join=True, start_method="spawn")


def cli_world(device=None, gpus: Optional[int] = None) -> int:
    """The ranks a CLI runs on: every visible card, or `gpus` of them
    (JAX's min(--gpus, devices), nerfmeshes_tpu/cli/train_nerf.py:83); on
    the host (`device` "cpu"), `gpus` gloo ranks, 1 by default. One card
    named by its index ("cuda:3") is one rank on that card, and `gpus`
    above 1 beside it raises."""
    if device is not None and torch.device(device).type == "cpu":
        return max(1, int(gpus or 1))
    if device is not None and torch.device(device).index is not None:
        if gpus and int(gpus) > 1:
            raise ValueError(f"--device {device} names one card and --gpus {gpus} asks for "
                             f"{gpus}: pass --device cuda to spread the ranks over the cards")
        return 1
    visible = default_world()
    return min(int(gpus), visible) if gpus else visible


def _cli_rank(group: DataGroup, body: Callable, args) -> None:
    body(args, group)


def run_cli(body: Callable, args, world: int):
    """body(args, group) for a CLI whose parsed `args` name a `device`:
    as a rank of the torchrun group when there is one, else on `world`
    spawned ranks (returning None), else in this process on one rank
    (returning what body returns). Spawned ranks take cuda:r unless
    `device` names something other than the card."""
    group = from_env(args.device)
    if group is not None:
        return body(args, group)
    if world > 1:
        device = None if args.device in (None, "cuda") else args.device
        launch(_cli_rank, world, device, args=(body, args))
        return None
    return body(args, single(args.device))


# -- collectives (no-ops on an unforced one-rank group) ---------------------------

def all_sum_(tensor: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """Sum `tensor` over the group, in place."""
    if group.sharded:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    return tensor


def all_mean_(tensor: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """Average `tensor` over the group, in place (JAX's pmean: the sum
    over ranks, divided by their count)."""
    if group.sharded:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
        tensor.div_(group.world)
    return tensor


def gather_rows(tensors: Sequence[torch.Tensor], group: DataGroup) -> list:
    """Each rank's (n, ...) tensors -> the (world * n, ...) tensors with
    rank r's rows at [r * n, (r + 1) * n): the tensors are packed side by
    side into one zero-filled buffer, this rank's rows written, and the
    buffer summed over the group in one all_reduce. One dtype throughout."""
    tensors = list(tensors)
    if not group.sharded:
        return tensors
    n = tensors[0].shape[0]
    cols = [t.reshape(n, -1) for t in tensors]
    widths = [c.shape[1] for c in cols]
    buf = torch.zeros((group.world * n, sum(widths)), dtype=cols[0].dtype,
                      device=cols[0].device)
    buf[group.rank * n:(group.rank + 1) * n] = torch.cat(cols, dim=1)
    all_sum_(buf, group)
    return [part.reshape(group.world * n, *t.shape[1:])
            for part, t in zip(buf.split(widths, dim=1), tensors)]


def broadcast_(tensor: torch.Tensor, group: DataGroup, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `tensor` on every rank, in place."""
    if group.sharded:
        dist.broadcast(tensor, src)
    return tensor


@torch.no_grad()
def broadcast_params(params: Sequence[torch.Tensor], group: DataGroup) -> None:
    """Rank 0's parameters on every rank, as one flat broadcast."""
    params = list(params)
    if not group.sharded or not params:
        return
    flat = broadcast_(torch.cat([p.detach().reshape(-1) for p in params]), group)
    for p, v in zip(params, flat.split([p.numel() for p in params])):
        p.copy_(v.view_as(p))


def broadcast_text(text: Optional[str], group: DataGroup) -> str:
    """Rank 0's `text` on every rank (its UTF-8 length, then its bytes,
    each broadcast as a tensor on the group's device)."""
    if not group.sharded:
        return text
    data = text.encode() if group.is_main else b""
    size = broadcast_(torch.tensor([len(data)], dtype=torch.int64, device=group.device), group)
    buf = torch.zeros(int(size.item()), dtype=torch.uint8, device=group.device)
    if group.is_main:
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    return bytes(broadcast_(buf, group).cpu().numpy()).decode()


# -- per-rank random streams ----------------------------------------------------

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_seed(*values: int) -> int:
    """A 63-bit seed mixed from host integers (JAX's fold_in, on the host)."""
    x = 0
    for v in values:
        x = _splitmix64(x ^ (int(v) & _MASK64))
    return x >> 1


class RankStream:
    """The per-rank random stream of a sharded step. JAX folds the shard
    index into the pixel and render keys of every step (nerfmeshes_tpu/
    train/step.py:225-245); here a generator on the rank's device is
    reseeded at every micro-step from (seed, step, rank), host integers
    only, so deriving it never waits for the device, a resume on the same
    world size draws what the uninterrupted run drew, and a checkpoint
    carries nothing of it."""

    def __init__(self, seed: int, rank: int, device):
        self.seed = int(seed)
        self.rank = int(rank)
        self.generator = torch.Generator(device)

    def at(self, step: int) -> torch.Generator:
        return self.generator.manual_seed(fold_seed(self.seed, step, self.rank))
