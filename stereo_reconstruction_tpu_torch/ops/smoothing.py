"""Smoothness-reweighted argmin over the cost volume (exact Right-variant
reference mode).

Port of ``stereo_reconstruction_tpu/ops/smoothing.py``
(``volume_reductions``, ``smoothed_argmin_from_inputs``,
``smoothed_argmin_reference``). The reference interleaves a multiplicative
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
) -> torch.Tensor:
    """The exact smoothing row scan from the five planes; (H, W) float32
    disparity with the reference sentinels (black -> 0, no candidate ->
    -x)."""
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
    prev = torch.zeros((w,), dtype=f32, device=device)
    for y in range(h):
        m0r, a0r, c0r = m0[y], a0[y].to(torch.int64), c_zero[y]
        # up-neighbour candidate (exact: prev is the final row above);
        # row 0 has no up neighbour
        up_zero = prev == 0.0
        up_idx = torch.where(up_zero, i_zero, up_sent_idx)
        if y == 0:
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
