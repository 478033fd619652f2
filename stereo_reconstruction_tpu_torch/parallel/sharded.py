"""Sharded dense matching: cost-volume row tiles across the mesh.

Port of ``stereo_reconstruction_tpu/parallel/sharded.py``. The matcher's
H dimension is split over the ``tile`` axis and the batch of pairs over
``data``; each tile takes halo rows from its row neighbours by
``ppermute``. Metric reductions are ``psum``s (``sharded_evaldisp``).

Exactness: the cost of a tile is computed in global row coordinates (K1
or the plain volume with ``row_offset`` / ``total_height``), so window
clipping and area are the whole image's on every kept row: a tile's
edges are never taken for image borders.

The smoothing recurrence runs down all rows. With ``exact=False`` each
tile re-runs it over ``warmup`` rows above its block (taken with the
halo) and keeps its own rows: the up chain's influence decays, so the
rest of the divergence is confined to rare tie chains. With
``exact=True`` (the wavefront) the tile scans are chained instead: tile
t's scan is seeded with the final row of tile t - 1, and ``n_tiles``
seeded passes, each ``ppermute``-ing the last row one tile down, make the
output bit-identical to the single-device matcher. The cost stays one
launch per tile; only the row scan (K1b) repeats, ``n_tiles`` times.

On CUDA tensors each (pair, tile) launches K1 once (the kernel route,
``backend="auto"`` or ``"pallas"``) and K1b ``n_tiles`` times (``exact``)
or once; on the plain route (``backend="xla"``) the global-row volume and
its reductions take K1's place, and K1b still runs the scan.
"""

from __future__ import annotations

import torch

from stereo_reconstruction_tpu_torch.config import MatcherConfig
from stereo_reconstruction_tpu_torch.ops import cost_volume as cv
from stereo_reconstruction_tpu_torch.ops import cuda_cost_volume as ccv
from stereo_reconstruction_tpu_torch.ops import cuda_row_scan as crs
from stereo_reconstruction_tpu_torch.ops import smoothing
from stereo_reconstruction_tpu_torch.parallel.mesh import shard_map


async def _halo_exchange(shard, block: torch.Tensor, top_halo: int, bottom_halo: int,
                         axis: str) -> torch.Tensor:
    """``block`` (Hloc, ...) with ``top_halo`` rows of the previous shard
    along ``axis`` above it and ``bottom_halo`` rows of the next below
    (zeros at the ends; one hop, so both are at most Hloc)."""
    n, idx = shard.axis_size(axis), shard.axis_index(axis)
    h = block.shape[0]
    # my first rows are the previous shard's bottom halo, my last rows the
    # next shard's top halo
    from_next = await shard.ppermute(block[:bottom_halo], axis,
                                     [(i, (i - 1) % n) for i in range(n)])
    from_prev = await shard.ppermute(block[h - top_halo:], axis,
                                     [(i, (i + 1) % n) for i in range(n)])
    if idx == 0:
        from_prev = torch.zeros_like(from_prev)
    if idx == n - 1:
        from_next = torch.zeros_like(from_next)
    return torch.cat([from_prev, block, from_next])


def kernel_route(config: MatcherConfig, device: torch.device) -> bool:
    """Whether the sharded matcher takes K1 (``backend="pallas"``, or
    ``"auto"`` on CUDA; the wrapper runs its plain twin on the CPU, as the
    JAX package runs its Pallas kernel in interpret mode there) or the
    plain global-row volume (``"xla"``)."""
    if config.backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown matcher backend {config.backend!r}")
    return config.backend == "pallas" or (config.backend == "auto"
                                          and device.type == "cuda")


def sharded_block_search_right(
    left: torch.Tensor,     # (B, H, W, 3) batch of rectified pairs
    right: torch.Tensor,    # (B, H, W, 3)
    mesh,
    config: MatcherConfig = MatcherConfig(),
    warmup: int = 32,       # smoothing warm-up rows above each tile
    exact: bool = False,    # wavefront mode: bit-identical to one device
) -> torch.Tensor:
    """(B, H, W) float32 disparity; B split over ``data``, H over ``tile``
    (H must divide into ``tile`` tiles, B into ``data`` parts).

    ``exact=True`` chains the smoothing recurrence across tiles (module
    docstring): bit-identical to ``block_search_right`` of each pair."""
    if config.cost != "ssd" or config.var_block:
        raise NotImplementedError(
            "the sharded matcher computes the SSD cost with one block size "
            f"(cost={config.cost!r}, var_block={config.var_block})")
    if config.min_disparity < 0:
        raise NotImplementedError("min_disparity < 0 is refused on every route")
    hbs = (config.block_size - 1) // 2
    hw = 2 * hbs
    h = int(right.shape[1])
    n_tiles = mesh.shape["tile"]
    if h % n_tiles:
        raise ValueError(f"H = {h} does not split into {n_tiles} row tiles")
    rows_per_tile = h // n_tiles
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    warmup = 0 if exact else min(warmup, rows_per_tile - hw)
    if warmup < 0:
        raise ValueError(f"a {rows_per_tile}-row tile is shorter than the "
                         f"{hw}-row window halo (one-hop exchange)")
    top_halo, bottom_halo = warmup + hw, hw
    D = config.max_disparity - config.min_disparity
    use_k1 = kernel_route(config, right.device)
    volume_args = (config.block_size, config.min_disparity, config.max_disparity)

    async def per_pair(shard, lb, rb):
        lb_h = await _halo_exchange(shard, lb, top_halo, bottom_halo, "tile")
        rb_h = await _halo_exchange(shard, rb, top_halo, bottom_halo, "tile")
        idx = shard.axis_index("tile")
        row0 = idx * rows_per_tile - top_halo     # global id of local row 0
        n_rows = warmup + rows_per_tile
        keep = slice(hw, hw + n_rows)             # drop the window-support rows
        black = cv.black_pixel_mask(rb_h[keep])
        local = torch.arange(n_rows, device=rb.device)
        gids = row0 + hw + local
        if exact:
            # only the true image top starts the chain; every other tile's
            # first row is seeded by the wavefront
            first = gids == 0
        else:
            # the image top and each tile's first warm-up row (the cut)
            first = (gids <= 0) | (local == 0)
        lf, rf = lb_h.to(torch.float32), rb_h.to(torch.float32)
        if use_k1:
            planes = ccv.matcher_inputs(lf, rf, *volume_args, row_offset=row0,
                                        total_height=h)
            planes = [p[keep] for p in planes]
        else:
            cost = cv.cost_volume_right_ssd(lf, rf, *volume_args, row_offset=row0,
                                            total_height=h)
            planes = smoothing.volume_reductions(cost[:, keep], config.min_disparity)
            del cost

        def smooth(seed):
            return crs.row_scan(*planes, black, smooth_factor=config.smooth_factor,
                                d_first=config.min_disparity, n_planes=D,
                                first_flags=first, init_prev=seed)

        seed = torch.zeros((rb.shape[1],), dtype=torch.float32, device=rb.device)
        if not exact:
            return smooth(seed)[warmup:]
        # the wavefront: n_tiles seeded passes, the last row sent one tile
        # down after each (tile 0 receives zeros and ignores them: `first`)
        perm_down = [(i, i + 1) for i in range(n_tiles - 1)]
        for _ in range(n_tiles):
            disp = smooth(seed)
            seed = await shard.ppermute(disp[-1], "tile", perm_down)
        return disp

    async def local(shard, left_blk, right_blk):
        # (Bloc, Hloc, W, 3) each
        return torch.stack([await per_pair(shard, lb, rb)
                            for lb, rb in zip(left_blk, right_blk)])

    spec_in = ("data", "tile", None, None)
    return shard_map(local, mesh, [spec_in, spec_in], ("data", "tile", None),
                     left, right)


def sharded_evaldisp(
    disp: torch.Tensor,     # (B, H, W) split like the matcher's output
    gt: torch.Tensor,
    mask: torch.Tensor,
    mesh,
    bad_thresh: float = 2.0,
    max_disp: float = 1e9,
):
    """The Middlebury metrics of the whole batch: each shard counts its
    block, one ``psum`` over ``tile`` and ``data`` adds the counts."""

    async def local(shard, d, g, m):
        d = d.to(torch.float32)
        g = g.to(torch.float32)
        evaluated = torch.isfinite(g) & (m == 255)
        valid = d != 0
        dd = torch.where(valid, d.clamp(0.0, max_disp), d)
        err = (dd - g).abs()
        ev = evaluated & valid
        stats = torch.stack([
            evaluated.sum().to(torch.float32),
            ev.sum().to(torch.float32),
            (ev & (err > bad_thresh)).sum().to(torch.float32),
            torch.where(ev, err, 0.0).sum(),
        ])
        stats = await shard.psum(await shard.psum(stats, "tile"), "data")
        n, n_valid, bad, serr = stats
        invalid = n - n_valid
        return torch.stack([
            100.0 * bad / n.clamp(min=1),
            100.0 * invalid / n.clamp(min=1),
            100.0 * (bad + invalid) / n.clamp(min=1),
            serr / n_valid.clamp(min=1),
        ])

    spec = ("data", "tile", None)
    vals = shard_map(local, mesh, [spec, spec, spec], (), disp, gt, mask)
    return {
        "bad_percent": vals[0],
        "invalid_percent": vals[1],
        "total_bad_percent": vals[2],
        "avg_err": vals[3],
    }
