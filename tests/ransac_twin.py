"""The RANSAC kernel's plain twin with its rounding pinned to the kernel's,
and the comparison that holds the kernel to it. Shared by
``test_torch_ransac_host.py`` (the kernel's source built for the host),
``test_torch_cuda.py`` and ``chip_smoke.py`` (the kernel on the card),
which put this directory on ``sys.path``.

The twin is ``pose/ransac.py::ransac_plain`` with its rounding pinned to the
kernel's where it leaves the order to a library (``pinned_twin``):

* float32 ``torch.sqrt`` correctly rounded, as the card's and the
  kernel's are (PyTorch's vectorised CPU sqrt is one ulp off on ~0.7% of
  inputs);
* every matrix product summed in order, unfused, as the kernel sums it
  (BLAS and cuBLAS choose their order and contract into FMAs), chi^T chi
  (``eight_point.gram``) included, and the Sampson distance's x'^T F x
  (``ransac._sampson_sq``'s ``torch.sum`` over three rows, whose order the
  card's reduction picks);
* F (``geometry.fundamental_from_essential``) with the intrinsics'
  inverse as the adjugate (``small_linalg.inv3``), as the kernel forms it,
  where the twin factors it (LU), and its norm's nine squares summed in
  order;
* the triangulation's sums over the sample's points (the secular
  equation's two in ``small_linalg.arrow_smallest_eigvec``, the corner in
  ``geometry.triangulate_depths``) and the sample's pixel errors (the
  mean) in the order the kernel's group of 8 lanes takes them (``tree_sum``).

Two of those sums are ill-conditioned in float32. With 8 points the two
smallest eigenvalues of chi^T chi lie below float32's resolution of its
entries: one ulp there moves a hypothesis's eigenvector by ~1e-2 and its
inlier count by tens (on the posed fixture, against the CPU twin's own
order, 16% of the hypotheses' inlier counts differ). And an inlier's
x'^T F x cancels terms a thousand times its size: an FMA, another order or
one ulp of F's norm there moves ``match_fit`` by ~1e-4 to 5e-4 (the card's
twin against the kernel). With the order pinned, ``compare`` holds the
kernel to:

* the samples, equal;
* each hypothesis's inlier count, equal on >= 99% of them and never more
  than 1 apart;
* the winner and the best fitting hypothesis, the same;
* E, R and T of every hypothesis and of the result, and the result's
  mean_error and fit_error, within 1e-4 relative; where no hypothesis is
  valid, the result's mean_error within 1e-3: its points' depths have
  mixed signs, the secular equation's root (which the bisection's sums, in
  another order, place 1e-6 apart) moves them by ~6e-7, and its residuals
  of ~0.2 px are differences of ~500 px coordinates (5.8e-4 measured);
* the mean pixel error over its sample of each valid hypothesis whose R
  and T equal the twin's bit for bit (about half of them on the fixtures;
  at least ``SAME_POSE_SHARE`` must), within ``HYP_MEAN_ERROR`` of its own
  value (0 measured). Its depths come from the secular equation's root,
  whose clamped Newton steps settle into a cycle of two floats: the third
  step undoes the second, so a solve with one step fewer moves this error
  by up to ~7e-5 on ~10% of the hypotheses (the fixtures' draws), as one
  ulp of R or T, or the secular equation summed in another order, does;
* the other ``RansacResult`` fields, equal.

``compare`` prints the largest deviation of each and returns them.
"""

from __future__ import annotations

import contextlib
import importlib
from unittest import mock

import torch

from stereo_reconstruction_tpu_torch.ops import geometry as geo
from stereo_reconstruction_tpu_torch.ops import small_linalg
from stereo_reconstruction_tpu_torch.ops.cost_volume import sqrt_rn
from stereo_reconstruction_tpu_torch.pose import ransac as pransac

# the module, not the function that ``pose/__init__`` exports under its name
eight_point_module = importlib.import_module("stereo_reconstruction_tpu_torch.pose.eight_point")

# the mean sample error of a valid hypothesis with the twin's R and T,
# relative to itself; and the least share of the valid hypotheses that
# must have the twin's R and T
HYP_MEAN_ERROR = 1e-6
SAME_POSE_SHARE = 0.1


def gram_in_order(chi):
    """chi^T chi summed over the points in order, as the kernel sums it."""
    acc = torch.zeros(chi.shape[:-2] + (chi.shape[-1],) * 2, dtype=chi.dtype, device=chi.device)
    for k in range(chi.shape[-2]):
        acc = acc + chi[..., k, :, None] * chi[..., k, None, :]
    return acc


def matmul_in_order(a, b):
    """a @ b with each entry summed over k in order, each product and sum
    rounded on its own, as the kernel computes its small products."""
    if b.dim() == 1:
        return matmul_in_order(a, b[:, None])[..., 0]
    terms = a[..., :, :, None] * b[..., None, :, :]
    acc = terms[..., 0, :]
    for k in range(1, terms.shape[-2]):
        acc = acc + terms[..., k, :]
    return acc


def sampson_sq_in_order(F, xl, xr):
    """``ransac._sampson_sq`` with x'^T F x summed over the rows in order."""
    Fx = F @ xl
    Ftx = F.mT @ xr
    dot = (xr[..., 0, :] * Fx[..., 0, :] + xr[..., 1, :] * Fx[..., 1, :]
           + xr[..., 2, :] * Fx[..., 2, :])
    den = Fx[..., 0, :] ** 2 + Fx[..., 1, :] ** 2 + Ftx[..., 0, :] ** 2 + Ftx[..., 1, :] ** 2
    return dot ** 2 / torch.clamp_min(den, 1e-12)


def fundamental_in_order(E, K_left, K_right):
    """``geometry.fundamental_from_essential`` with the adjugate inverses
    and the norm summed over the entries in order."""
    F = small_linalg.inv3(K_right).mT @ E @ small_linalg.inv3(K_left)
    squares = F * F
    total = squares[..., 0, 0]
    for k in range(1, 9):
        total = total + squares[..., k // 3, k % 3]
    return F / sqrt_rn(total)[..., None, None]


def tree_sum(x):
    """The sum over the last axis as ``csrc/ransac.cuh::group_sum`` takes a
    sample's points: lane j of 8 adds points j, j + 8, ... in order, then
    the lanes meet as ((l0 + l4) + (l2 + l6)) + ((l1 + l5) + (l3 + l7))."""
    n = x.shape[-1]
    lanes = []
    for j in range(8):
        terms = [x[..., i] for i in range(j, n, 8)]
        acc = terms[0] if terms else torch.zeros_like(x[..., 0])
        for t in terms[1:]:
            acc = acc + t
        lanes.append(acc)
    return (((lanes[0] + lanes[4]) + (lanes[2] + lanes[6]))
            + ((lanes[1] + lanes[5]) + (lanes[3] + lanes[7])))


class _TreeSumTorch:
    """``torch`` with ``sum`` over the last axis and ``mean`` over it (or
    over a vector) taken as ``tree_sum``, for the twin's own code: in place
    of a module's ``torch`` while it runs."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def sum(x, dim=None, **kw):
        if dim != -1 or kw:
            return torch.sum(x, dim=dim, **kw)
        return tree_sum(x)

    @staticmethod
    def mean(x, dim=None):
        if not (dim == -1 or (dim is None and x.dim() == 1)):
            return torch.mean(x) if dim is None else torch.mean(x, dim=dim)
        return tree_sum(x) / x.shape[-1]


class _TreeMeanTorch(_TreeSumTorch):
    """``_TreeSumTorch`` with ``sum`` left as it is."""

    sum = staticmethod(torch.sum)


def triangulate_depths_in_order(points_left_norm, points_right_norm, R, T):
    """``geometry.triangulate_depths`` with each 3-vector's dot product
    summed in order, the corner over the points as ``tree_sum`` takes them,
    and ``small_linalg.arrow_smallest_eigvec``'s sums the same way."""
    Rxl = (R @ points_left_norm).mT
    skew_xr = geo.skew(points_right_norm.mT)
    col_i = (skew_xr @ Rxl[..., :, None])[..., 0]
    col_T = (skew_xr @ T[..., None, :, None])[..., 0]

    def dot3(a, b):
        return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]

    with mock.patch.object(small_linalg, "torch", _TreeSumTorch()):
        _, depths = small_linalg.arrow_smallest_eigvec(
            dot3(col_i, col_i), dot3(col_i, col_T), tree_sum(dot3(col_T, col_T)))
    return depths


@contextlib.contextmanager
def pinned_twin():
    """``ransac_plain`` with its rounding pinned to the kernel's (above),
    for the time of the block."""
    sqrt = torch.sqrt
    with contextlib.ExitStack() as stack:
        for target, name, value in [
            (torch, "sqrt", lambda x: sqrt(x.double()).to(x.dtype)),
            (eight_point_module, "gram", gram_in_order),
            (torch.Tensor, "__matmul__", matmul_in_order),
            (pransac, "_sampson_sq", sampson_sq_in_order),
            (geo, "fundamental_from_essential", fundamental_in_order),
            (geo, "triangulate_depths", triangulate_depths_in_order),
            (pransac, "torch", _TreeMeanTorch()),
        ]:
            stack.enter_context(mock.patch.object(target, name, value))
        yield


def rel(a, b):
    """Largest |a - b| over the largest |b|, NaN where both are NaN skipped."""
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    _require(torch.equal(torch.isnan(a), torch.isnan(b)), "NaN in one and not the other")
    keep = ~torch.isnan(b)
    a, b = a[keep], b[keep]
    if b.numel() == 0:
        return 0.0
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def twin_picks(hyp):
    score = hyp.inliers.to(torch.float32) - 1e-6 * hyp.mean_error
    fits = torch.where(hyp.inliers == torch.amax(hyp.inliers), hyp.fits, torch.inf)
    return int(torch.argmax(score)), int(torch.argmin(fits))


def _require(ok, what):
    if not ok:
        raise AssertionError(what)


def compare(kernel, ml, mr, n_valid, config, K, u, device="cpu"):
    """``kernel(ml, mr, K_left, K_right, n_valid, u, config)`` on a batch of
    one on ``device``, returning (its ``RansacResult`` fields, its scratch),
    against the pinned twin on the CPU, to the limits above; (the kernel's
    result, the twin's, the deviations). ``ml``, ``mr`` (3, N), ``K`` (3, 3)
    and ``u`` (num_hypotheses, N) may lie on any device. The twin runs on
    the CPU, whose small sums (over 3 entries in ``svd3_for_essential`` and
    the triangulation) run in order as the kernel's do; the card's
    reductions pick another order, and one ulp of E moves an inlier's
    Sampson distance by ~1e-4."""
    ml, mr, K, u = (t.detach().cpu() for t in (ml, mr, K, u))
    nv = torch.as_tensor(n_valid).cpu().to(torch.int64)
    with pinned_twin():
        want = pransac.ransac_plain(ml, mr, K, K, config, nv, u)
        hyp = pransac.score_hypotheses(ml, mr, K, K, config, nv, u)
    got, scratch = kernel(*(t[None].to(device) for t in (ml, mr, K, K, nv, u)), config)
    got = pransac.RansacResult(*(x.cpu() for x in got))
    hyp_f, hyp_i, picked = (x.cpu() for x in scratch[:3])
    s = config.sample_size
    _require(torch.equal(hyp_i[0, :, 3:3 + s].long(), hyp.samples), "samples differ")
    inliers = hyp_i[0, :, 0].long()
    same = float((inliers == hyp.inliers).float().mean())
    apart = int((inliers - hyp.inliers).abs().max())
    _require(same >= 0.99 and apart <= 1,
             f"inlier counts equal on {same:.4f} of the hypotheses, up to {apart} apart")
    valid = hyp.results.valid
    _require(torch.equal(hyp_i[0, :, 1].bool(), valid), "validity differs")
    _require(tuple(picked[0].tolist()) == twin_picks(hyp),
             f"winner and fit {picked[0].tolist()} against the twin's {twin_picks(hyp)}")
    same_pose = (valid & (hyp_f[0, :, :9] == hyp.results.rotation.reshape(-1, 9)).all(-1)
                 & (hyp_f[0, :, 9:12] == hyp.results.translation).all(-1))
    share = float(same_pose.sum()) / max(int(valid.sum()), 1)
    _require(share >= SAME_POSE_SHARE or not bool(valid.any()),
             f"R and T equal the twin's on {share:.3f} of the valid hypotheses")
    kernel_err, twin_err = hyp_f[0, :, 21].double(), hyp.mean_error.double()
    dev = {
        "hyp_R": rel(hyp_f[0, :, :9], hyp.results.rotation.reshape(-1, 9)),
        "hyp_T": rel(hyp_f[0, :, 9:12], hyp.results.translation),
        "hyp_E": rel(hyp_f[0, :, 12:21], hyp.results.essential.reshape(-1, 9)),
        "hyp_mean_error": float(((kernel_err - twin_err).abs()
                                 / twin_err.abs().clamp_min(1e-30))[same_pose].max())
        if bool(same_pose.any()) else 0.0,
    }
    for field in want._fields:
        a, b = getattr(got, field)[0], getattr(want, field)
        if a.dtype.is_floating_point:
            dev[field] = rel(a, b)
        else:
            _require(torch.equal(a, b), f"{field} differs")
    print({k: f"{v:.3g}" for k, v in dev.items()}, f"same pose on {share:.3f}")
    limits = {"hyp_mean_error": HYP_MEAN_ERROR}
    if not bool(want.valid):
        limits["mean_error"] = 1e-3
    over = {k: v for k, v in dev.items() if v > limits.get(k, 1e-4)}
    _require(not over, f"beyond the limits: {over}")
    return got, want, dev


def card_kernel(ml, mr, K_left, K_right, n_valid, u, config):
    """``cuda_ransac.ransac`` on card tensors with its scratch kept, in
    ``compare``'s form: (the ``RansacResult`` fields, the scratch)."""
    from stereo_reconstruction_tpu_torch.ops import cuda_ransac

    scratch = cuda_ransac.scratch_buffers(ml.shape[0], config, ml.shape[-1], ml.device)
    out = cuda_ransac.ransac(ml, mr, K_left, K_right, n_valid, u, config, scratch=scratch)
    torch.cuda.synchronize(ml.device)
    return out, scratch
