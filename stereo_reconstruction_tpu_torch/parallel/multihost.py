"""Multi-process execution: one mesh shard per ``torch.distributed`` rank.

Port of ``stereo_reconstruction_tpu/parallel/multihost.py``. Every
process runs the same program over one global ``("data", "tile")`` mesh
(``global_mesh``): rank r holds the shard (r // tile, r % tile), on
``cuda:<r mod device count>`` under NCCL or on the CPU under gloo, and the
collectives of a ``shard_map`` body are the process group's. The sharded
entry points (``parallel.sharded``, ``parallel.ba_dist``,
``parallel.ba_multiview``) run on it unchanged.

Inputs and outputs of the entry points are global tensors on every
process: ``from_local_shards`` assembles one from each process's block,
``replicate`` gives every process rank 0's value, and ``gather`` fetches
a result to the host.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from stereo_reconstruction_tpu_torch.parallel.mesh import AXES, Shard, _MeshBase, _step


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group. The arguments default to the
    ``STEREO_COORDINATOR`` / ``STEREO_NUM_PROCESSES`` /
    ``STEREO_PROCESS_ID`` environment variables; a coordinator is a
    ``host:port`` (a TCP store) or an ``init_method`` URL such as
    ``file:///path``. ``backend`` defaults to NCCL where CUDA is available,
    else gloo."""
    coord = coordinator_address or os.environ.get("STEREO_COORDINATOR")
    if not coord:
        raise ValueError("no coordinator: pass coordinator_address or set "
                         "STEREO_COORDINATOR")
    n = num_processes if num_processes is not None else os.environ.get(
        "STEREO_NUM_PROCESSES")
    pid = process_id if process_id is not None else os.environ.get("STEREO_PROCESS_ID")
    if n is None or pid is None:
        raise ValueError("pass num_processes and process_id or set "
                         "STEREO_NUM_PROCESSES / STEREO_PROCESS_ID")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_method = coord if "://" in coord else f"tcp://{coord}"
    dist.init_process_group(backend, init_method=init_method, world_size=int(n),
                            rank=int(pid))


class ProcessGroupMesh(_MeshBase):
    """The (data, tile) mesh over the ranks of the default process group,
    one shard per rank."""

    def __init__(self, data: int, tile: int):
        super().__init__(data, tile)
        world = dist.get_world_size()
        if data * tile != world:
            raise ValueError(f"mesh {data}x{tile} != {world} processes")
        self.rank = dist.get_rank()
        self.coords = dict(data=self.rank // tile, tile=self.rank % tile)
        if dist.get_backend() == "nccl":
            self.device = torch.device("cuda", self.rank % torch.cuda.device_count())
            torch.cuda.set_device(self.device)      # NCCL's device for this rank
        else:
            self.device = torch.device("cpu")
        # one group per line of shards along each axis, made by every rank
        # in the same order; the flattened mesh is the whole world
        self.groups = {}
        for axis in AXES:
            other = [a for a in AXES if a != axis][0]
            for j in range(self.shape[other]):
                ranks = [c["data"] * tile + c["tile"] for c in self.all_coords()
                         if c[other] == j]
                group = dist.new_group(ranks)
                if self.coords[other] == j:
                    self.groups[(axis,)] = group
        self.groups[AXES] = dist.group.WORLD
        # every rank joins one collective before the first batched send
        # (NCCL sets up the world's communicator on it)
        dist.barrier()

    def _rank(self, axes: tuple, idx: int) -> int:
        """The global rank of the shard at index ``idx`` along ``axes``
        that shares this rank's coordinates off ``axes``."""
        coords = dict(self.coords)
        for a in reversed(axes):
            idx, coords[a] = divmod(idx, self.shape[a])
        return coords["data"] * self.shape["tile"] + coords["tile"]

    def _ppermute(self, x: torch.Tensor, axes: tuple, perm, me: int) -> torch.Tensor:
        """``x`` of the source that ``perm`` pairs with this shard (zeros
        where none does), by point-to-point sends: each shard moves only
        the bytes of its own pairs."""
        x = x.contiguous()
        out = torch.zeros_like(x)
        ops = []
        for s, d in perm:
            if s == me and d == me:
                out.copy_(x)
            elif s == me:
                ops.append(dist.P2POp(dist.isend, x, self._rank(axes, d)))
            elif d == me:
                ops.append(dist.P2POp(dist.irecv, out, self._rank(axes, s)))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out

    def _group(self, axes: tuple):
        if axes not in self.groups:
            raise ValueError(f"no process group along {axes!r} (axes: {AXES})")
        return self.groups[axes]

    def _all_gather(self, x: torch.Tensor, group):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return parts

    def run(self, body, args, in_specs):
        """{this rank's (data, tile): the body's return value}."""
        shard = Shard(self, self.coords, self.device)
        blocks = [self.block(x, s, self.coords, self.device) for x, s in zip(args, in_specs)]
        coro = body(shard, *blocks)
        req, ret = _step(coro, None)
        while req is not None:
            group = self._group(req.axes)
            if req.op == "psum":
                value = req.x.clone()
                dist.all_reduce(value, group=group)
            elif req.op == "ppermute":
                value = self._ppermute(req.x, req.axes, req.perm, shard.axis_index(req.axes))
            else:
                value = torch.cat(self._all_gather(req.x, group))
            req, ret = _step(coro, value)
        return {(self.coords["data"], self.coords["tile"]): ret}

    def assemble(self, blocks: dict, spec) -> torch.Tensor:
        """The global output: replicated as it is, else every rank's block
        gathered and placed."""
        (mine,) = blocks.values()
        if not any(names is not None for names in spec):
            return mine
        parts = self._all_gather(mine, dist.group.WORLD)
        coords = self.all_coords()
        return self.place({(c["data"], c["tile"]): p for c, p in zip(coords, parts)}, spec)


def global_mesh(data: int = 1, tile: int = 1) -> ProcessGroupMesh:
    """The ``("data", "tile")`` mesh over every process (``initialize``
    first); ``parallel.mesh.make_mesh`` builds the one-process kind."""
    return ProcessGroupMesh(data, tile)


def from_local_shards(local: torch.Tensor, mesh: ProcessGroupMesh, spec) -> torch.Tensor:
    """The global tensor whose block, as ``spec`` splits it, is ``local``
    on every process (the multi-process analog of ``torch.as_tensor``)."""
    return mesh.assemble({(mesh.coords["data"], mesh.coords["tile"]):
                          torch.as_tensor(local).to(mesh.device)}, spec)


def replicate(value, mesh: ProcessGroupMesh) -> torch.Tensor:
    """Rank 0's ``value`` on every process."""
    t = torch.as_tensor(value).to(mesh.device).clone()
    dist.broadcast(t, src=0)
    return t


def gather(arr: torch.Tensor) -> np.ndarray:
    """A global tensor (every entry point's output is one on every
    process) as a host array."""
    return arr.detach().cpu().numpy()
