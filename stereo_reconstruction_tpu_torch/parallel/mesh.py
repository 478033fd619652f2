"""Device meshes and the collectives the sharded entry points run on.

Port of ``stereo_reconstruction_tpu/parallel/mesh.py``. The JAX package
expresses all distribution as shardings over one ``("data", "tile")``
mesh: ``data`` carries a batch of stereo pairs (or the BA's points),
``tile`` the cost volume's row tiles, and each sharded entry point is a
``shard_map`` of a per-shard body that talks to the other shards through
collectives (``axis_index``, ``axis_size``, ``ppermute``, ``psum``,
``all_gather``).

PyTorch has no SPMD over local devices, so a mesh here is an explicit
(data, tile) grid of shards, each with its ``torch.device`` (a device may
repeat: ``["cuda:0"] * 8`` stands where the JAX tests force eight host
devices), and ``shard_map`` runs a body written once, as an ``async``
function of a ``Shard`` handle and the shard's blocks. Its collectives are
awaited: ``x = await shard.psum(x, "tile")``. There are two meshes:

* ``Mesh`` (``make_mesh``): one process runs every shard in turn. Each
  body runs to its next collective; when all have reached it, the
  collective is computed with tensor operations and each body resumes.
* ``ProcessGroupMesh`` (``multihost.global_mesh``): one shard per
  process of a ``torch.distributed`` group, the collectives are the
  group's (gloo on the CPU, NCCL on the card).

Inputs and outputs of ``shard_map`` are global tensors; a spec names, for
each leading dimension, the mesh axis (or tuple of axes, the first
major) that splits it, ``None`` where it is whole. An output spec of
``()`` is replicated: every shard holds the same value.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch

AXES = ("data", "tile")


def _axes(names) -> tuple:
    return (names,) if isinstance(names, str) else tuple(names)


def _index(shape: dict, coords: dict, names) -> int:
    """The index of the shard at ``coords`` along ``names`` (flattened,
    the first axis major)."""
    idx = 0
    for a in _axes(names):
        idx = idx * shape[a] + coords[a]
    return idx


def _count(shape: dict, names) -> int:
    n = 1
    for a in _axes(names):
        n *= shape[a]
    return n


class Shard:
    """One shard's view of the mesh inside a ``shard_map`` body."""

    def __init__(self, mesh, coords: dict, device: torch.device):
        self.mesh = mesh
        self.coords = coords
        self.device = device

    def axis_index(self, names) -> int:
        """The shard's index along ``names`` (flattened, first axis major)."""
        return _index(self.mesh.shape, self.coords, names)

    def axis_size(self, names) -> int:
        return _count(self.mesh.shape, names)

    def psum(self, x: torch.Tensor, names):
        """The sum of ``x`` over the shards along ``names``."""
        return _Collective("psum", x, _axes(names))

    def ppermute(self, x: torch.Tensor, names, perm):
        """``x`` of the shard at source index s for each (s, d) in ``perm``,
        at destination d; zeros where no pair names this shard."""
        return _Collective("ppermute", x, _axes(names), tuple(map(tuple, perm)))

    def all_gather(self, x: torch.Tensor, names):
        """The ``x`` of every shard along ``names``, concatenated on dim 0
        in index order (JAX's ``all_gather(tiled=True)``)."""
        return _Collective("all_gather", x, _axes(names))


class _Collective:
    """An awaited collective: the body yields it and resumes with its
    result."""

    def __init__(self, op: str, x: torch.Tensor, axes: tuple, perm=()):
        self.op, self.x, self.axes, self.perm = op, x, axes, perm

    def __await__(self):
        return (yield self)


def _step(coro, value):
    """Resume ``coro`` with ``value``: (next collective, None) or (None,
    the body's return value)."""
    try:
        return coro.send(value), None
    except StopIteration as stop:
        return None, stop.value


class _MeshBase:
    """What both meshes share: the (data, tile) grid and the block
    arithmetic of the specs."""

    def __init__(self, data: int, tile: int):
        if data < 1 or tile < 1:
            raise ValueError(f"mesh {data}x{tile} must have data, tile >= 1")
        self.shape = {"data": data, "tile": tile}

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["tile"]

    def all_coords(self):
        return [dict(data=d, tile=t)
                for d, t in itertools.product(range(self.shape["data"]),
                                              range(self.shape["tile"]))]

    def block(self, x, spec, coords: dict, device: torch.device):
        """The block of the global ``x`` that the shard at ``coords`` holds,
        on ``device`` (``spec`` None: the whole of ``x``). Raises
        ``ValueError`` where ``x`` lies on another kind of device than the
        shard: a card tensor is never moved to the host (nor the reverse)."""
        if not torch.is_tensor(x):
            return x
        if x.device.type != device.type:
            raise ValueError(f"a {x.device.type} tensor given to a mesh shard on "
                             f"{device}: put the inputs on the mesh's devices")
        for dim, names in enumerate(spec or ()):
            if names is None:
                continue
            n, size = _count(self.shape, names), x.shape[dim]
            if size % n:
                raise ValueError(f"dimension {dim} of size {size} does not split "
                                 f"into {n} shards along {names!r}")
            x = x.narrow(dim, _index(self.shape, coords, names) * (size // n), size // n)
        return x.to(device)

    def place(self, blocks: dict, spec) -> torch.Tensor:
        """The global tensor of every shard's block ({(data, tile):
        block}), as ``spec`` splits it; a replicated ``spec`` takes the
        first shard's."""
        first = blocks[min(blocks)]
        if not any(names is not None for names in spec):
            return first
        shape = list(first.shape)
        for dim, names in enumerate(spec):
            if names is not None:
                shape[dim] *= _count(self.shape, names)
        out = torch.empty(shape, dtype=first.dtype, device=first.device)
        for (d, t), b in blocks.items():
            view = out
            for dim, names in enumerate(spec):
                if names is not None:
                    idx = _index(self.shape, dict(data=d, tile=t), names)
                    view = view.narrow(dim, idx * b.shape[dim], b.shape[dim])
            view.copy_(b)
        return out


class Mesh(_MeshBase):
    """A (data, tile) grid of devices in one process; ``shard_map`` runs
    its shards in turn."""

    def __init__(self, devices: Sequence, data: int, tile: int):
        super().__init__(data, tile)
        devices = [torch.device(d) for d in devices]
        if len(devices) != data * tile:
            raise ValueError(f"data*tile = {data}*{tile} != {len(devices)} devices")
        self.devices = [devices[d * tile:(d + 1) * tile] for d in range(data)]

    def device(self, coords: dict) -> torch.device:
        return self.devices[coords["data"]][coords["tile"]]

    def data_blocks(self, batch: int) -> list:
        """[(rows, device)] for each data index i in order: the slice of
        batch rows ``[i * batch / data, (i + 1) * batch / data)`` and the
        device of shard (i, 0). JAX's spec ``P("data", None, ...)``
        replicates each block over ``tile``, so every tile of a data index
        computes the same; here it is computed once, on its ``tile=0``
        device, which gives the same result. Raises ``ValueError`` where
        ``batch`` is not a multiple of ``data``, as JAX's ``device_put``
        does."""
        n = self.shape["data"]
        if batch % n:
            raise ValueError(f"a batch of {batch} does not split into data={n} shards")
        size = batch // n
        return [(slice(i * size, (i + 1) * size), self.device(dict(data=i, tile=0)))
                for i in range(n)]

    def run(self, body, args, in_specs):
        """{(data, tile): the body's return value} of every shard."""
        shards, coros, values = {}, {}, {}
        for c in self.all_coords():
            key = (c["data"], c["tile"])
            dev = self.device(c)
            shards[key] = Shard(self, c, dev)
            blocks = [self.block(x, s, c, dev) for x, s in zip(args, in_specs)]
            coros[key] = body(shards[key], *blocks)
            values[key] = None
        results = {}
        while coros:
            requests = {}
            for key, coro in coros.items():
                req, ret = _step(coro, values[key])
                if req is None:
                    results[key] = ret
                else:
                    requests[key] = req
            coros = {k: c for k, c in coros.items() if k in requests}
            if requests and len(requests) != self.size:
                raise RuntimeError("shards reached different collectives "
                                   f"({len(requests)} of {self.size} waiting)")
            values = self._serve(requests, shards)
        return results

    def assemble(self, blocks: dict, spec) -> torch.Tensor:
        """The global output from every shard's block (all are here)."""
        return self.place({k: b.to(blocks[min(blocks)].device)
                           for k, b in blocks.items()}, spec)

    def _serve(self, requests: dict, shards: dict) -> dict:
        """Every shard's result of one collective, from tensor operations."""
        first = next(iter(requests.values()), None)
        if first is None:
            return {}
        if any((r.op, r.axes, r.perm) != (first.op, first.axes, first.perm)
               for r in requests.values()):
            raise RuntimeError(f"shards reached different collectives at {first.op}")
        out = {}
        for members in self._groups(first.axes):
            xs = [requests[k].x for k in members]
            idx = {k: shards[k].axis_index(first.axes) for k in members}
            by_idx = {idx[k]: k for k in members}
            if first.op == "psum":
                total = xs[0]
                for x in xs[1:]:
                    total = total + x.to(total.device)
                for k in members:
                    out[k] = total.to(shards[k].device)
            elif first.op == "ppermute":
                src_of = {d: s for s, d in first.perm}
                for k in members:
                    s = src_of.get(idx[k])
                    out[k] = (torch.zeros_like(requests[k].x) if s is None
                              else requests[by_idx[s]].x.to(shards[k].device))
            else:
                ordered = [requests[by_idx[i]].x for i in range(len(members))]
                for k in members:
                    out[k] = torch.cat([x.to(shards[k].device) for x in ordered])
        return out

    def _groups(self, axes: tuple):
        """The shard keys that share every coordinate outside ``axes``,
        group by group."""
        others = [a for a in AXES if a not in axes]
        groups = {}
        for c in self.all_coords():
            groups.setdefault(tuple(c[a] for a in others), []).append(
                (c["data"], c["tile"]))
        return list(groups.values())


def make_mesh(data: int = 1, tile: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A one-process (data, tile) mesh over ``devices`` (default: every
    CUDA device); ``tile`` defaults to len(devices) // data. Raises
    ``ValueError`` where data * tile != len(devices), as JAX's does."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if tile is None:
        tile = n // data
    if data * tile != n:
        raise ValueError(f"data*tile = {data}*{tile} != {n} devices")
    return Mesh(devices, data, tile)


def shard_map(body, mesh, in_specs, out_specs, *args):
    """Run the ``async`` ``body(shard, *blocks)`` on every shard of
    ``mesh`` and assemble its outputs: each of ``args`` is split by its
    spec in ``in_specs`` (``None`` passes it whole to every shard, on the
    shard's device), the output placed by ``out_specs``; where the body
    returns a tuple, ``out_specs`` is a list with one spec each."""
    results = mesh.run(body, args, in_specs)
    if isinstance(out_specs, list):
        return tuple(mesh.assemble({k: r[i] for k, r in results.items()}, s)
                     for i, s in enumerate(out_specs))
    return mesh.assemble(results, out_specs)
