"""Data-parallel training: one process a rank, DDP's gradient all-reduce.

Port of ``diffwave_sashimi_tpu/parallel/mesh.py``.  There, one program
shards the batch over a ``('data',)`` mesh and XLA inserts the gradient
psum; here, as in the reference's ``distributed_train``, each rank is a
process of its own that trains on its rows of the global batch, and
``DistributedDataParallel`` averages the gradients over the ranks (NCCL
on the card, gloo on the CPU).  ``mesh.data: -1`` means every visible
card, as JAX's ``make_mesh(data=-1)`` and the reference's
``device_count()`` do; on the CPU it means one rank.

:func:`launch` starts the ranks (``spawn``), each in a process group whose
rendezvous is a file store in a fresh temporary directory, so two runs on
one machine never meet.  A rank that raises ends the others, and the
launcher raises the first failing rank's error.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def world_size(data=-1, device_type: str = "cuda") -> int:
    """The number of ranks ``mesh.data`` asks for on ``device_type``: -1
    (or None) is every visible card on ``cuda`` and one rank on the CPU;
    more ranks than cards raises."""
    data = -1 if data is None else int(data)
    if data != -1 and data < 1:
        raise ValueError(f"mesh.data={data}: a number of ranks >= 1, or -1 "
                         f"for every card")
    if device_type != "cuda":
        return 1 if data == -1 else data
    cards = torch.cuda.device_count()
    if data == -1:
        return cards
    if data > cards:
        raise ValueError(f"mesh.data={data} asks for {data} ranks, one a "
                         f"card, and {cards} card(s) are visible")
    return data


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank r's device: ``cuda:r`` (modulo the visible cards, so that a
    gloo group may put two ranks on one card), or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def distributed() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def is_main_process() -> bool:
    """The rank-0 gate for files, prints and in-training samples (every
    process is the main one outside a process group)."""
    return not distributed() or dist.get_rank() == 0


def row_range(rank: int, world: int, global_batch: int) -> Tuple[int, int]:
    """[start, stop) of rank ``rank``'s rows of the global batch."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} is not a multiple of "
                         f"{world} ranks")
    per = global_batch // world
    return rank * per, (rank + 1) * per


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks (``x`` itself outside a process
    group)."""
    if not distributed():
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x / dist.get_world_size()


def agree(flag: bool, device: torch.device) -> bool:
    """Rank 0's ``flag`` on every rank (``flag`` outside a process group),
    so that every rank takes the same stop decision."""
    if not distributed():
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.broadcast(t, src=0)
    return bool(t.item())


def data_parallel(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` wrapped in DDP, which averages the gradients over the
    ranks.  The parameters the training loss never reaches
    (``model.unreached_in_training()``) are left out of the reduction:
    their gradients stay None on every rank, Adam never moves them, and
    they stay what rank 0 broadcast.  Every other parameter must get a
    gradient every step, or DDP raises at the next one."""
    from torch.nn.parallel import DistributedDataParallel as DDP
    DDP._set_params_and_buffers_to_ignore_for_model(
        model, model.unreached_in_training())
    return DDP(model, device_ids=None)


def _run_rank(rank: int, fn: Callable, world: int, backend: str,
              device_type: str, store_dir: str, args: Sequence,
              timeout: Optional[float], threads: Optional[int]) -> None:
    device = rank_device(rank, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)   # the kernels launch on its stream
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(store_dir, "store"),
        rank=rank, world_size=world, timeout=None if timeout is None
        else datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, world, device, *args)
        torch.save(out, os.path.join(store_dir, f"rank{rank}.pt"))
    except BaseException:
        _note_failure(store_dir, rank)
        raise
    finally:
        dist.destroy_process_group()


def _note_failure(store_dir: str, rank: int) -> None:
    """Write this rank's traceback to ``failed<rank>`` in the store
    directory, stamped with the time and its pid, before its connections
    close: the other ranks fail later, on those connections, and the
    launcher reports the first rank to fail, whichever process it hears
    from first."""
    import traceback
    path = os.path.join(store_dir, f"failed{rank}")
    with open(path + ".tmp", "w") as f:
        f.write(f"{time.time()!r} {os.getpid()}\n{traceback.format_exc()}")
    os.replace(path + ".tmp", path)


def _first_failure(store_dir: str,
                   world: int) -> Optional[Tuple[int, int, str]]:
    """(rank, pid, traceback) of the rank that failed first, or None."""
    noted = []
    for r in range(world):
        path = os.path.join(store_dir, f"failed{r}")
        if os.path.exists(path):
            with open(path) as f:
                head, text = f.read().split("\n", 1)
            stamp, pid = head.split()
            noted.append((float(stamp), r, int(pid), text))
    return min(noted)[1:] if noted else None


def launch(fn: Callable, world: int, backend: str, device_type: str = "cuda",
           args: Sequence = (), timeout: Optional[float] = None) -> List[Any]:
    """``fn(rank, world, device, *args)`` in ``world`` spawned processes,
    each a rank of a ``backend`` ("nccl" or "gloo") process group, also
    at world 1; returns each rank's return value (through ``torch.save``,
    tensors as they were).  ``fn`` and ``args`` must pickle: a module's
    top-level function.  A rank that raises ends the rest, and this
    raises the error of the rank that failed first (the others fail on its
    closed connections); a collective that waits past ``timeout`` seconds
    (torch's default when None) raises in its rank.  On the CPU each rank
    takes an even share of the caller's torch threads (at least one): a
    spawned process starts with one thread a core, so ``world`` ranks
    would otherwise ask the cores for ``world`` times as many."""
    import torch.multiprocessing as mp
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; ask "
                           "for the CPU to run on the CPU")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one rank a card: {world} ranks, "
                         f"{torch.cuda.device_count()} card(s)")
    threads = (None if device_type == "cuda"
               else max(1, torch.get_num_threads() // world))
    with tempfile.TemporaryDirectory(prefix="dwst_ranks_") as store_dir:
        try:
            mp.spawn(_run_rank, args=(fn, world, backend, device_type,
                                      store_dir, tuple(args), timeout,
                                      threads),
                     nprocs=world, join=True)
        except mp.ProcessRaisedException as e:
            first = _first_failure(store_dir, world)
            if first is None:
                raise
            rank, pid, text = first
            raise mp.ProcessRaisedException(
                f"\n\n-- Process {rank} failed first:\n{text}", rank,
                pid) from e
        return [torch.load(os.path.join(store_dir, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
