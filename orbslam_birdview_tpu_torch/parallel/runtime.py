"""The mesh the sharded solvers run on, and the multi-process runtime.

The JAX package shards over a `jax.sharding.Mesh` inside one process and
brings up `jax.distributed` across hosts. Here:

- `Mesh` is a tuple of `torch.device`s, one per local shard; a device may
  repeat (`[cuda:0] * 4`, `[cpu] * 8`), so the same shard-local code, the
  same reductions and the same partition run on one card as on four;
- `Mesh.psum` sums the shards' partials in shard order on the first
  device, then, when the mesh carries a process group of more than one
  rank, `all_reduce`s that sum across the processes: the order of the
  in-process sum is fixed, so a result does not vary from run to run;
- `init_distributed` brings up `torch.distributed` (NCCL on CUDA, gloo on
  the CPU or where named).

Sharding is the caller's choice: a `System` (and its mapper) runs on
`Mesh([device])`, the one-device solvers, unless it is given a mesh of
more shards, e.g. `Mesh([f"cuda:{i}" for i in range(n)])`. The JAX
package shards whenever it sees more than one device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


class Mesh:
    """A 1-D mesh of shards over `devices`, optionally spanning the
    processes of `group` (each process holding the same number of local
    shards; process r owns global shards r·n .. r·n + n - 1)."""

    def __init__(self, devices: Sequence, group=None):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        for d in devices:
            if d.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        f"mesh device {d}: no CUDA device is available")
                if (d.index or 0) >= torch.cuda.device_count():
                    raise RuntimeError(
                        f"mesh device {d}: only {torch.cuda.device_count()} "
                        "GPUs are visible")
        self.devices = devices
        self.group = group
        if group is not None:
            import torch.distributed as dist

            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        else:
            self.world, self.rank = 1, 0

    @property
    def size(self) -> int:
        """Local shards: the shards of this process."""
        return len(self.devices)

    @property
    def n_shards(self) -> int:
        """Shards over every process of the mesh."""
        return len(self.devices) * self.world

    @property
    def first_shard(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * len(self.devices)

    def psum(self, parts):
        """Σ over every shard of the mesh of the per-shard `parts` (one
        tensor per local shard): summed in shard order on devices[0], then
        all-reduced over the process group."""
        d0 = self.devices[0]
        out = parts[0].to(d0)
        for p in parts[1:]:
            out = out + p.to(d0)
        if self.world > 1:
            import torch.distributed as dist

            if len(parts) == 1 and out is parts[0]:
                out = out.clone()       # all_reduce works in place
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def broadcast(self, x):
        """`x` on every local shard's device (no copy where it lies)."""
        copies = {}
        out = []
        for d in self.devices:
            key = str(d)
            if key not in copies:
                copies[key] = x if x.device == d else x.to(d)
            out.append(copies[key])
        return out

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"world={self.world}, rank={self.rank})")


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None):
    """Bring up `torch.distributed` for a multi-process mesh: NCCL when CUDA
    is available, gloo otherwise, or `backend`. `coordinator` is an init
    method (`tcp://host:port`, `file:///path`; a bare `host:port` means
    tcp). Returns (world size, rank); raises when the group does not come
    up."""
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator is not None and "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size(), dist.get_rank()
