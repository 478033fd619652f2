"""Smoothness-reweighted argmin over the cost volume.

Port of ``stereo_reconstruction_tpu/ops/smoothing.py``. The exact
Right-variant reference mode (``volume_reductions``,
``smoothed_argmin_from_inputs``, ``smoothed_argmin_reference``) comes
first; ``smoothed_argmin`` (any mode and variant, fixed sweeps or the
fixpoint) and ``plain_argmin`` follow. The reference interleaves a multiplicative
smoothness discount with the argmin (BlockSearch.cpp:160-171): a
candidate's cost is multiplied by ``smoothFactor`` when the up (y-1, x)
or left (y, x-1) neighbour chose ``-d`` (the Right variant's sign quirk).
With candidate disparities ``>= 0`` the discount can only hit ``d == 0``
or ``d == x`` (a sentinel neighbour), so five (H, W) planes of the volume
carry everything the recurrence needs:

  m0       min over D
  a0       first-argmin plane index (int32)
  c_zero   the d == 0 plane (+inf if 0 is not a candidate)
  diag_up  cost[x - d_first] at column x (+inf out of range)
  diag_lf  cost[x - 1 - d_first] at column x (+inf out of range)

The row scan is a Python loop over rows (the up-neighbour recurrence);
inside a row the left-neighbour dependence is a 3-state automaton whose
per-pixel transition tables compose by log2(W) doubling steps. Ties keep
the first index (strict ``<``), as in the reference. This loop is the plain
twin of K1b (``ops/cuda_row_scan.py``), which runs it on the card.
"""

from __future__ import annotations

from typing import Optional

import torch


def volume_reductions(cost: torch.Tensor, d_first: int = 0):
    """The five (H, W) planes of the exact smoothing scan, from the full
    (D, H, W) volume."""
    D, h, w = cost.shape
    device = cost.device
    m0, a0 = torch.min(cost, dim=0)
    a0 = a0.to(torch.int32)
    i_zero = -d_first
    inf_plane = torch.full((h, w), float("inf"), dtype=cost.dtype, device=device)
    # a copy: a view would keep the whole volume alive
    c_zero = cost[i_zero].clone() if 0 <= i_zero < D else inf_plane
    xi = torch.arange(w, device=device)

    def diag(offset):
        """cost[x - offset, y, x], +inf where the plane index leaves [0, D)."""
        idx = xi - offset
        ok = (idx >= 0) & (idx < D)
        g = cost.gather(0, idx.clamp(0, D - 1).expand(1, h, w))[0]
        return torch.where(ok[None, :], g, inf_plane)

    return m0, a0, c_zero, diag(d_first), diag(d_first + 1)


def smoothed_argmin_from_inputs(
    m0: torch.Tensor,          # (H, W) min over D
    a0: torch.Tensor,          # (H, W) int32 first-argmin plane index
    c_zero: torch.Tensor,      # (H, W) the d == 0 plane (+inf if no plane)
    diag_up: torch.Tensor,     # (H, W) cost[x - d_first]   (+inf o.o.r.)
    diag_lf: torch.Tensor,     # (H, W) cost[x-1-d_first]   (+inf o.o.r.)
    black: torch.Tensor,       # (H, W) bool
    smooth_factor: float = 0.9,
    d_first: int = 0,
    n_planes: int = 1,
    first_flags: Optional[torch.Tensor] = None,   # (H,) bool
    init_prev: Optional[torch.Tensor] = None,     # (W,) float32
) -> torch.Tensor:
    """The exact smoothing row scan from the five planes; (H, W) float32
    disparity with the reference sentinels (black -> 0, no candidate ->
    -x).

    ``first_flags`` marks the rows with no up neighbour (default: row 0
    alone), and ``init_prev`` is row 0's up neighbour where its flag is
    clear (default 0): a row tile continues the recurrence from the final
    row of the tile above this way (the sharded matcher's wavefront)."""
    h, w = m0.shape
    device = m0.device
    D = n_planes
    f32 = torch.float32
    sf = torch.tensor(smooth_factor, dtype=f32, device=device)
    one = torch.ones((), dtype=f32, device=device)
    inf = torch.tensor(float("inf"), dtype=f32, device=device)
    zero = torch.zeros((), dtype=f32, device=device)
    xi = torch.arange(w, device=device)
    sentinel = -xi.to(f32)
    i_zero = -d_first
    up_sent_idx = (xi - d_first).clamp(0, D - 1)
    # the three left-neighbour cases, stacked on dim 0:
    # 0 = none, 1 = left chose 0, 2 = left is the sentinel -x
    lf_idx = torch.stack([
        torch.full((w,), -1, device=device),
        torch.full((w,), i_zero, device=device),
        (xi - 1 - d_first).clamp(0, D - 1),
    ])
    inf_row = torch.full((w,), float("inf"), dtype=f32, device=device)

    def lexmin(v1, i1, v2, i2):
        """(value, index) lexicographic min — first-argmin tie semantics."""
        take2 = (v2 < v1) | ((v2 == v1) & (i2 < i1))
        return torch.where(take2, v2, v1), torch.where(take2, i2, i1)

    out = torch.empty((h, w), dtype=f32, device=device)
    prev = (torch.zeros((w,), dtype=f32, device=device) if init_prev is None
            else init_prev.to(device=device, dtype=f32))
    firsts = ([True] + [False] * (h - 1) if first_flags is None
              else [bool(f) for f in first_flags.tolist()])
    for y in range(h):
        m0r, a0r, c0r = m0[y], a0[y].to(torch.int64), c_zero[y]
        # up-neighbour candidate (exact: prev is the final row above); a
        # first row has no up neighbour
        up_zero = prev == 0.0
        up_idx = torch.where(up_zero, i_zero, up_sent_idx)
        if firsts[y]:
            v_u = inf_row
        else:
            up_sent = prev == sentinel
            up_val = torch.where(up_zero, c0r, torch.where(up_sent, diag_up[y], inf))
            v_u = up_val * sf

        lf_val = torch.stack([inf_row, c0r, diag_lf[y]])             # (3, W)
        both = (lf_idx == up_idx) & torch.isfinite(v_u) & torch.isfinite(lf_val)
        extra = torch.where(both, sf, one)
        best, bidx = lexmin(m0r, a0r, v_u * extra, up_idx)
        best, bidx = lexmin(best, bidx, lf_val * sf * extra, lf_idx)
        disp = torch.where(torch.isfinite(best), (d_first + bidx).to(f32), sentinel)
        disp = torch.where(black[y], zero, disp)                     # (3, W)

        # per-pixel case transition g[x, c_in] = case(disp under c_in)
        g = torch.where(disp == 0.0, 1, torch.where(disp == sentinel, 2, 0)).T
        # inclusive prefix composition comp[x] = g[x] o ... o g[0]
        # ((b o a)[c] = b[a[c]]) by doubling
        off = 1
        while off < w:
            g = torch.cat([g[:off], torch.gather(g[off:], 1, g[:-off])])
            off *= 2
        case_in = torch.cat([torch.zeros((1,), dtype=g.dtype, device=device),
                             g[:-1, 0]])
        row = torch.gather(disp, 0, case_in[None, :])[0]
        out[y] = row
        prev = row
    return out


def smoothed_argmin_reference(
    cost: torch.Tensor,        # (D, H, W), +inf = invalid candidate
    black: torch.Tensor,       # (H, W) bool: pixels forced to 0
    smooth_factor: float = 0.9,
    d_first: int = 0,          # dvals = d_first + arange(D); requires >= 0
) -> torch.Tensor:
    """Exact reference-mode smoothing from the full volume."""
    if d_first < 0:
        raise ValueError("d_first < 0 needs the fixpoint smoother (not ported)")
    m0, a0, c_zero, diag_up, diag_lf = volume_reductions(cost, d_first)
    return smoothed_argmin_from_inputs(
        m0, a0, c_zero, diag_up, diag_lf, black,
        smooth_factor=smooth_factor, d_first=d_first, n_planes=cost.shape[0],
    )


def smoothed_argmin(
    cost: torch.Tensor,        # (D, H, W), +inf = invalid candidate
    dvals: torch.Tensor,       # (D,) disparity value of each plane
    black: torch.Tensor,       # (H, W) bool: pixels forced to 0
    smooth_factor: float = 0.9,
    mode: str = "reference",
    iters: Optional[int] = 2,
    variant: str = "right",
) -> torch.Tensor:
    """The (H, W) float32 disparity of the smoothing recurrence for any
    ``mode`` ("reference": the Right variant's -d sign quirk; "intended":
    +d, the Left variant's; "none": no discount) and ``variant`` (the
    no-candidate sentinel is -x for "right", +x for "left").

    Rows run in order (the up neighbour is the final row above). Inside a
    row, sweep 0 takes no left neighbour and each later sweep discounts
    against the previous sweep's left-shifted disparities; black pixels
    are forced to 0 after every sweep. ``iters`` sweeps in all, or with
    ``iters=None`` until a sweep changes nothing (at most W sweeps after
    the first): the fixpoint is the sequential recurrence's unique
    solution, so it is exact for every mode. Convergence is tested after
    every sweep, as JAX's while loop does."""
    D, h, w = cost.shape
    device = cost.device
    f32 = torch.float32
    dvals = dvals.to(device=device, dtype=f32)
    # a plane is discounted where sign * its value equals the neighbour's
    # disparity, i.e. where hit_vals equals it
    hit_vals = (-dvals if mode == "reference" else dvals)[:, None]
    xs = torch.arange(w, dtype=f32, device=device)
    sentinel = -xs if variant == "right" else xs
    sf = torch.tensor(smooth_factor, dtype=f32, device=device)
    zero = torch.zeros((), dtype=f32, device=device)
    nan_row = torch.full((w,), float("nan"), dtype=f32, device=device)

    def discounted(c, c_sf, neighbour):
        """c (D, W) with c_sf (= c * smooth_factor) where a plane hits the
        neighbour's disparity: c * discount, as c * 1 is c."""
        if mode == "none":
            return c
        return torch.where(hit_vals == neighbour[None, :], c_sf, c)

    out = torch.empty((h, w), dtype=f32, device=device)
    prev = None
    for y in range(h):
        black_row = black[y]
        cu = cost[:, y, :]
        if y > 0:
            cu = discounted(cu, cu * sf, prev)
        cu_sf = cu * sf

        def sweep(left_disp):
            best, idx = torch.min(discounted(cu, cu_sf, left_disp), dim=0)
            disp = torch.where(torch.isfinite(best), dvals[idx], sentinel)
            return torch.where(black_row, zero, disp)

        def shifted(d):
            return torch.cat([nan_row[:1], d[:-1]])

        disp = sweep(nan_row)
        if iters is None:
            last, disp, done = disp, sweep(shifted(disp)), 1
            while done < w and not torch.equal(disp, last):
                last, disp = disp, sweep(shifted(disp))
                done += 1
        else:
            for _ in range(max(0, iters - 1)):
                disp = sweep(shifted(disp))
        out[y] = disp
        prev = disp
    return out


def plain_argmin(cost: torch.Tensor, dvals: torch.Tensor, black: torch.Tensor,
                 variant: str = "right") -> torch.Tensor:
    """Unsmoothed winner-take-all disparity, (H, W) float32."""
    D, h, w = cost.shape
    best, idx = torch.min(cost, dim=0)
    xs = torch.arange(w, dtype=torch.float32, device=cost.device)
    sentinel = -xs if variant == "right" else xs
    dvals = dvals.to(device=cost.device, dtype=torch.float32)
    disp = torch.where(torch.isfinite(best), dvals[idx], sentinel[None, :])
    return torch.where(black, 0.0, disp)
