"""Communicators over `torch.distributed` and the observation sharding of
`bundle_adjustment_tpu/parallel/sharding.py`.

A `Comm` is the port's counterpart of one axis of a JAX `Mesh`: a process
group with this process's ``rank`` and ``size`` and the device its tensors
live on.  It offers the collectives the sharded modules use, with the JAX
names:

    psum(x)                 all-reduce sum (`jax.lax.psum`)
    pmax(x)                 all-reduce max (`jax.lax.pmax`)
    all_gather(x, dim)      tiled: the ranks' slices concatenated in rank
                            order along ``dim`` (`all_gather(tiled=True)`)
    psum_scatter(x, dim)    tiled: the sum, of which this rank keeps its
                            own 1/size slice along ``dim``
    broadcast(x, src)       the value of group rank ``src`` on every rank

A group of one rank still calls the collectives (NCCL at world size 1 runs
the same code path as on several cards).

Two forms of the gather and the scatter, chosen when the communicator is
built (and named in its ``repr``), never by catching an error:

* ``direct``: `all_gather_into_tensor` / `reduce_scatter_tensor` (NCCL on
  CUDA tensors with one rank per card; gloo on CPU tensors);
* ``all_reduce``: both formed from `all_reduce`, the one reduction besides
  `broadcast` that gloo takes for CUDA tensors (several ranks sharing one
  card): the gather is the sum of a zero buffer that holds the rank's
  slice at its place (adding zeros is exact), the scatter is the rank's
  slice of the sum.

Every all-reduce hands each rank the same bits (the ring's reduced chunks
are broadcast), so values read on the host after a collective agree
across ranks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

DIRECT = "direct"
ALL_REDUCE = "all_reduce"


def collective_form(backend: str, device: torch.device) -> str:
    """The form of gather / scatter a backend takes for tensors on
    ``device``: `all_reduce` for gloo on CUDA tensors, else `direct`."""
    return ALL_REDUCE if backend == "gloo" and device.type == "cuda" \
        else DIRECT


class Comm:
    """One axis of ranks over the process group ``group`` (None: every
    rank).  ``device``: where the collectives' tensors live (default: the
    current CUDA device for NCCL, else the CPU).  ``form``: `DIRECT` or
    `ALL_REDUCE` (default `collective_form`)."""

    def __init__(self, group=None, device=None, form: str | None = None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device()) \
                if self.backend == "nccl" else torch.device("cpu")
        self.device = torch.device(device)
        if form is None:
            form = collective_form(self.backend, self.device)
        if form not in (DIRECT, ALL_REDUCE):
            raise ValueError(f"form must be {DIRECT!r} or {ALL_REDUCE!r}, "
                             f"got {form!r}")
        self.form = form

    def __repr__(self):
        return (f"Comm(backend={self.backend}, rank={self.rank}, "
                f"size={self.size}, device={self.device}, form={self.form})")

    def _reduce(self, x, op):
        y = x.contiguous().clone()  # all_reduce works in place
        dist.all_reduce(y, op=op, group=self.group)
        return y

    def psum(self, x):
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x):
        return self._reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x, dim: int = 0):
        x0 = x.movedim(dim, 0).contiguous()
        n = x0.shape[0]
        if self.form == DIRECT:
            out = x0.new_empty((self.size * n, *x0.shape[1:]))
            dist.all_gather_into_tensor(out, x0, group=self.group)
        else:
            buf = x0.new_zeros((self.size, *x0.shape))
            buf[self.rank] = x0
            dist.all_reduce(buf, group=self.group)
            out = buf.reshape(self.size * n, *x0.shape[1:])
        return out.movedim(0, dim)

    def psum_scatter(self, x, dim: int = 0):
        x0 = x.movedim(dim, 0).contiguous()
        if x0.shape[0] % self.size:
            raise ValueError(f"psum_scatter: dimension {dim} of size "
                             f"{x0.shape[0]} is not a multiple of the "
                             f"{self.size} ranks")
        n = x0.shape[0] // self.size
        if self.form == DIRECT:
            out = x0.new_empty((n, *x0.shape[1:]))
            dist.reduce_scatter_tensor(out, x0, group=self.group)
        else:
            out = self.psum(x0)[self.rank * n:(self.rank + 1) * n]
        return out.movedim(0, dim)

    def broadcast(self, x, src: int):
        """The tensor ``x`` of group rank ``src`` on every rank (``x`` has
        the same shape and dtype everywhere; only src's values count)."""
        y = x.contiguous().clone()
        g = self.group if self.group is not None else dist.group.WORLD
        dist.broadcast(y, src=dist.get_global_rank(g, src), group=self.group)
        return y


def make_mesh(n_devices: int | None = None, device=None,
              form: str | None = None):
    """A `Comm` over the first ``n_devices`` ranks (default: all) of the
    initialised default process group.  Every rank must call it (the group
    is created collectively); a rank outside the group gets None."""
    world = dist.get_world_size()
    if n_devices is None or n_devices == world:
        return Comm(None, device, form)
    if not 0 < n_devices <= world:
        raise ValueError(f"n_devices {n_devices} outside [1, {world}]")
    group = dist.new_group(list(range(n_devices)))
    return Comm(group, device, form) if dist.get_rank() < n_devices else None


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_observations(problem, comm: Comm) -> dict:
    """This rank's slice of the observation arrays of a dense
    `models.problem.BundleProblem`, padded to a multiple of the ranks:
    obs_point, obs_image, obs_xy, obs_var, obs_rho and ``valid``, as
    tensors on ``comm.device`` (floats in float64).

    Pad rows point at index 0 with zero weight (obs_var 1, ``valid``
    False): they add nothing to any reduction.  Rank r holds rows
    [r Np / D, (r + 1) Np / D) of the padded arrays, as the JAX function's
    shard r does."""
    D = comm.size
    N = int(problem.num_image_obs)
    Np = pad_to_multiple(max(N, 1), D)
    n = Np // D
    lo, hi = comm.rank * n, (comm.rank + 1) * n

    def pad(a, fill=0):
        a = np.asarray(a)
        out = np.full((Np,) + a.shape[1:], fill, a.dtype)
        out[:N] = a
        return torch.as_tensor(out[lo:hi], device=comm.device)

    return {
        "obs_point": pad(problem.obs_point),
        "obs_image": pad(problem.obs_image),
        "obs_xy": pad(problem.obs_xy),
        "obs_var": pad(problem.obs_var, fill=1.0),
        "obs_rho": pad(problem.obs_rho),
        "valid": torch.as_tensor((np.arange(Np) < N)[lo:hi],
                                 device=comm.device),
    }
