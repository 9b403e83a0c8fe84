"""Multi-process set-up (port of `bundle_adjustment_tpu/parallel/multihost.py`).

Every rank runs the same program; `initialize` wires the processes into one
`torch.distributed` process group and `global_mesh` / `scenario_mesh` give
the communicators (`sharding.Comm`) the sharded modules take.  Start a
sharded run with ``torchrun --nproc-per-node=N script.py`` (one rank per
card: NCCL needs a card of its own for each rank) and call `initialize()`
with no arguments: it reads the ``env://`` variables torchrun sets.

`run_ranks` starts ranks as local processes (spawned: a child imports only
the module of its function) over a ``file://`` store, waits for each with a
time limit, and returns their results: the tests' and the chip check's
launcher.  A rank that fails or does not finish in time fails the call.
"""

from __future__ import annotations

import datetime
import os
import time
from pathlib import Path
from typing import NamedTuple

import torch
import torch.distributed as dist

from .sharding import Comm

#: process-group time limit unless the caller gives one
DEFAULT_TIMEOUT_S = 120.0

_DEVICE: torch.device | None = None


def _timeout(timeout) -> datetime.timedelta:
    if isinstance(timeout, datetime.timedelta):
        return timeout
    return datetime.timedelta(seconds=float(timeout))


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device="cuda",
               backend: str | None = None, init_method: str | None = None,
               timeout=DEFAULT_TIMEOUT_S) -> torch.device:
    """Join this process to the default process group and return its
    device.

    ``coordinator_address`` ("host:port") with ``num_processes`` and
    ``process_id``: a ``tcp://`` rendezvous; without it the ``env://``
    variables (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, as torchrun sets
    them).  ``init_method`` (e.g. ``file:///path``) replaces both.
    ``device``: "cuda" (default: the card LOCAL_RANK, or the process id
    modulo the cards), an explicit "cuda:i" (several ranks may share a
    card over gloo), or "cpu".  ``backend``: NCCL for CUDA, gloo for the
    CPU unless given.  Without a card the call raises unless
    ``device="cpu"``; NCCL missing raises too; nothing falls back."""
    global _DEVICE
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "multihost.initialize: torch.cuda.is_available() is false; pass "
            "device='cpu' to run the ranks on the CPU (gloo)")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("multihost.initialize: this torch has no NCCL")
    kwargs = {}
    if init_method is None and coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        init_method = f"tcp://{coordinator_address}"
    if init_method is None:
        init_method = "env://"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if dev.type == "cuda":
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            rank = int(local) if local is not None else int(
                process_id if process_id is not None
                else os.environ.get("RANK", 0))
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            timeout=_timeout(timeout), **kwargs)
    _DEVICE = dev
    return dev


def _device():
    if _DEVICE is None:
        raise RuntimeError("call multihost.initialize first")
    return _DEVICE


def global_mesh(axis: str = "obs") -> Comm:
    """A communicator over every rank, on this rank's device.  ``axis`` is
    the JAX mesh axis name, kept for the call's shape (a `Comm` has one
    axis)."""
    del axis
    return Comm(None, _device())


class ScenarioMesh(NamedTuple):
    """The 2-D split of the ranks: ``shape`` = (scenario, obs) sizes;
    ``scenario`` links the ranks that hold the same observation shard of
    different scenarios (no traffic in the scenario-batched step), ``obs``
    the ranks of one scenario's observation shards (its psums)."""

    scenario: Comm
    obs: Comm
    shape: tuple


def scenario_mesh(scenario_axis: str = "scenario", obs_axis: str = "obs",
                  scenarios_per_host: int = 1) -> ScenarioMesh:
    """The ranks as a [s, n / s] grid, s = min(scenarios_per_host x hosts,
    n) lowered to a divisor of n (the JAX function's rule; hosts = n /
    LOCAL_WORLD_SIZE as torchrun sets it, 1 without it).  Rank r sits at
    (r // (n / s), r % (n / s)): the observation groups are runs of
    consecutive ranks (one host under torchrun), the scenario groups span
    them.  Every rank must call it (groups are created collectively)."""
    del scenario_axis, obs_axis
    n = dist.get_world_size()
    hosts = max(1, n // int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    s = min(scenarios_per_host * hosts, n)
    while n % s != 0:
        s -= 1
    per = n // s
    rank = dist.get_rank()
    dev = _device()
    obs = scen = None
    for i in range(s):
        g = dist.new_group([i * per + j for j in range(per)])
        if rank // per == i:
            obs = Comm(g, dev)
    for j in range(per):
        g = dist.new_group([i * per + j for i in range(s)])
        if rank % per == j:
            scen = Comm(g, dev)
    return ScenarioMesh(scenario=scen, obs=obs, shape=(s, per))


def is_coordinator() -> bool:
    return dist.get_rank() == 0


# ---------------------------------------------------------------------------
# local launcher
# ---------------------------------------------------------------------------

def _rank_main(rank, fn, world_size, args, store, out, device, backend,
               timeout, threads, port):
    if threads:
        torch.set_num_threads(threads)
    if port is None:
        initialize(num_processes=world_size, process_id=rank, device=device,
                   backend=backend, init_method=f"file://{store}",
                   timeout=timeout)
    else:  # the env:// rendezvous, with the variables torchrun would set
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                          RANK=str(rank), WORLD_SIZE=str(world_size),
                          LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world_size))
        initialize(device=device, backend=backend, timeout=timeout)
    try:
        res = fn(global_mesh(), *args)
        torch.save(res, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(fn, world_size: int, args=(), *, workdir, device="cuda",
              backend: str | None = None, timeout=DEFAULT_TIMEOUT_S,
              threads: int | None = 1, rendezvous: str = "file",
              wait=None) -> list:
    """Run ``fn(comm, *args)`` on ``world_size`` spawned ranks and return
    each rank's result (saved with `torch.save`; keep it to CPU tensors
    and numbers), in rank order.

    ``fn`` must be a module-level function of a module whose import pulls
    in nothing heavy (a spawned child imports it).  ``workdir``: an empty
    directory for the ``file://`` store and the results.  ``device``,
    ``backend``: as `initialize` (e.g. "cuda:0" with "gloo" puts every
    rank on card 0).  ``timeout``: seconds, the process group's limit
    (each collective); ``wait``: seconds for all ranks to finish (default
    ``timeout``), on expiry every rank is killed and RuntimeError raised.
    A rank that exits non-zero raises too.
    ``threads``: torch's intra-op threads per rank (None: torch's
    default).  ``rendezvous``: "file" (the store in ``workdir``) or "env"
    (a free localhost port in the variables torchrun sets, read by
    `initialize()` without arguments).  Without a card, a CUDA ``device``
    raises here, before any rank starts."""
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "run_ranks: torch.cuda.is_available() is false; pass "
            "device='cpu' to run the ranks on the CPU (gloo)")
    if rendezvous not in ("file", "env"):
        raise ValueError(f"rendezvous must be 'file' or 'env', got "
                         f"{rendezvous!r}")
    port = _free_port() if rendezvous == "env" else None
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    store = work / "store"
    if store.exists():
        raise ValueError(f"{store} exists: give each launch a fresh workdir")
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, tuple(args), str(store), str(work),
                          device, backend, timeout, threads, port),
        nprocs=world_size, join=False, start_method="spawn")
    wait = float(timeout if wait is None else wait)
    deadline = time.monotonic() + wait
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"run_ranks: {world_size} ranks did not finish within "
                    f"{wait} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(world_size)]
