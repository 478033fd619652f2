"""The bundle-adjustment kernel's plain twin with its rounding pinned to the
kernel's, and the comparison that holds the kernel to it. Shared by
``test_torch_ba_host.py`` (the kernel's source built for the host),
``test_torch_cuda.py`` and ``chip_smoke.py`` (the kernel on the card),
which put this directory on ``sys.path``.

The twin is ``pose/ba.py::bundle_adjust_plain`` (the CPU route, unchanged)
with its rounding pinned to the kernel's where it leaves the order to a
library (``pinned_twin``):

* float32 ``torch.sqrt``, ``sin``, ``cos`` and ``arccos`` taken in float64
  and rounded once, as the kernel takes them (PyTorch's vectorised CPU
  sqrt is one ulp off on ~0.7% of inputs, and the CPU's, the host's and
  the card's float32 sin, cos and acos differ in the last bit); the
  forward-mode Jacobian then follows them through float64 too;
* every matrix product (``@``, the Jacobians' included) summed in order,
  each product and sum rounded on its own (BLAS chooses its order and
  contracts into FMAs);
* every ``einsum`` summed the same way: over the residual or coordinate
  index in order, then over the points in the kernel's tree order
  (``point_sum``), each product rounded on its own;
* the cost's and the Rodrigues angle's ``torch.sum`` in the same orders;
* F (``geometry.fundamental_from_essential``) with the intrinsics' adjugate
  inverses and its norm summed in order (``ransac_twin.fundamental_in_order``).

With those pinned, the kernel's arithmetic is the twin's operation for
operation: the forward-mode Jacobian's rules (a quotient's tangent
``(a' - b' q) / b``, a product's ``a' b + a b'``) written out, the same
guards and clamps, the same LM accept rule. ``compare`` holds it to the
twin bit for bit on every field. The card's float64 sin, cos and acos are
within two ulp of a double, so on a rare argument they could round to
another float than the host's; that would move the chain by an ulp, which
the free scale (below) can carry far. None of the test cases meets one.

Two of the twin's sums are ill-conditioned in float32. The 6x6 Schur
complement S is singular but for the damping along the two-view gauge
(the translation's length with the points' depths: no residual sees it),
so the step along it, and with it the length of T and the points' depths,
moves by ~1e4 times any rounding apart (ROADMAP, caveats). And the cost's
sum over the points cancels nothing but decides the accept rule: a step
that changes the cost by less than an ulp of it is accepted or not by
rounding alone, after which lambda differs by 100x. So the kernel is held
to the twin's bits, not to a tolerance: a copy of it that takes the
cost's butterfly in the other order, or one Jacobian quotient in another
form, fails ``test_torch_ba_host.py``.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

from stereo_reconstruction_tpu_torch.ops import geometry as geo
from stereo_reconstruction_tpu_torch.pose import ba as pba

from ransac_twin import fundamental_in_order, matmul_in_order


def warps_of(n: int) -> int:
    """The warps of a problem of n points: the least power of two that
    holds them, one point a thread."""
    w = 1
    while 32 * w < n:
        w *= 2
    return w


def halving(x):
    """The sum over the last axis, a power of two long, as entry i + entry
    i + h for h = half the length, then again on the first half."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def point_sum(x):
    """The sum over the last axis (the points) in the kernel's order: the
    points padded with zeros to its threads, each warp's 32 by ``halving``
    (its butterfly of shuffles, or its reading of a column of shared
    memory), then the warps' totals by ``halving``."""
    n = x.shape[-1]
    w = warps_of(n)
    x = torch.nn.functional.pad(x, (0, 32 * w - n))
    return halving(halving(x.reshape(x.shape[:-1] + (w, 32))))


def in_order(x, dim=-1, keepdim=False):
    """The sum over ``dim`` in order, each sum rounded on its own."""
    acc = x.select(dim, 0)
    for k in range(1, x.shape[dim]):
        acc = acc + x.select(dim, k)
    return acc.unsqueeze(dim) if keepdim else acc


def einsum_in_order(spec, a, b):
    """``torch.einsum(spec, a, b)`` for two operands: each product rounded
    on its own, summed over the contracted index other than ``n`` in order,
    then over ``n`` (the points) by ``point_sum``."""
    ins, out = spec.split("->")
    ia, ib = ins.split(",")
    contracted = [c for c in dict.fromkeys(ia + ib) if c not in out]
    inner = [c for c in contracted if c != "n"]
    points = [c for c in contracted if c == "n"]
    assert len(inner) <= 1, spec
    prod = torch.einsum(f"{ia},{ib}->{out}{''.join(inner)}{''.join(points)}", a, b)
    if inner:
        prod = in_order(prod, dim=prod.dim() - 1 - len(points))
    return point_sum(prod) if points else prod


class _PinnedTorch:
    """``torch`` with ``sum`` and ``einsum`` in the kernel's orders, in place
    of a module's ``torch`` while the twin runs."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def sum(x, dim=None, keepdim=False):
        if dim == -1:
            return in_order(x, -1, keepdim)
        assert dim is None and x.dim() == 2 and not keepdim
        return point_sum(in_order(x, -1))          # (N, 4): each point's, then the points

    einsum = staticmethod(einsum_in_order)


def _through_float64(fn):
    return lambda x: fn(x.double()).to(x.dtype)


@contextlib.contextmanager
def pinned_twin():
    """``bundle_adjust_plain`` with its rounding pinned to the kernel's
    (above), for the time of the block."""
    # a process's first forward-mode derivative scripts PyTorch's jvp
    # decompositions, which call torch.sqrt: it must not meet the stand-in
    torch.func.jvp(torch.sqrt, (torch.ones(()),), (torch.ones(()),))
    with contextlib.ExitStack() as stack:
        for target, name, value in [
            (torch, "sqrt", _through_float64(torch.sqrt)),
            (torch, "sin", _through_float64(torch.sin)),
            (torch, "cos", _through_float64(torch.cos)),
            (torch, "arccos", _through_float64(torch.arccos)),
            (torch.Tensor, "__matmul__", matmul_in_order),
            (pba, "torch", _PinnedTorch()),
            (geo, "torch", _PinnedTorch()),
            (geo, "fundamental_from_essential", fundamental_in_order),
        ]:
            stack.enter_context(mock.patch.object(target, name, value))
        yield


def twin_solves(kl, kr, K_left, K_right, weights, R0, T0, X0, config):
    """The pinned twin from each of the S starts ``R0`` (S, 3, 3), ``T0``
    (S, 3), ``X0`` (S, 3, N) of one pair, on the CPU: a ``BAResult`` whose
    fields have a leading S."""
    args = [t.detach().cpu() for t in (kl, kr, K_left, K_right, weights, R0, T0, X0)]
    kl, kr, K_left, K_right, weights, R0, T0, X0 = args
    with pinned_twin():
        solves = [pba.bundle_adjust_plain(kl, kr, K_left, K_right, R0[s], T0[s], X0[s],
                                          weights, config) for s in range(R0.shape[0])]
    return pba.BAResult(*(torch.stack(f) for f in zip(*solves)))


def compare(kernel, kl, kr, K_left, K_right, weights, R0, T0, X0, config, device="cpu"):
    """``kernel(kl, kr, K_left, K_right, weights, R0, T0, X0, config)`` on a
    batch of one pair with S starts on ``device``, returning the
    ``BAResult`` fields with leading (1, S), against the pinned twin on the
    CPU: every field equal bit for bit (NaN where the twin has NaN).
    Returns (the kernel's result, the twin's), each with a leading S."""
    want = twin_solves(kl, kr, K_left, K_right, weights, R0, T0, X0, config)
    got = kernel(*(t[None].to(device) for t in (kl, kr, K_left, K_right, weights, R0, T0, X0)),
                 config)
    got = pba.BAResult(*(x[0].cpu() for x in got))
    apart = {}
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        if not torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)) or not torch.equal(
                torch.isnan(a), torch.isnan(b)):
            apart[field] = float((a.double() - b.double()).abs().max()) \
                if a.dtype.is_floating_point else "differs"
    if apart:
        raise AssertionError(f"the kernel departs from the pinned twin: {apart}")
    return got, want


def card_kernel(kl, kr, K_left, K_right, weights, R0, T0, X0, config):
    """``cuda_ba.bundle_adjust`` on card tensors, in ``compare``'s form."""
    from stereo_reconstruction_tpu_torch.ops import cuda_ba

    out = cuda_ba.bundle_adjust(kl, kr, K_left, K_right, weights, R0, T0, X0, config,
                                pba.SETTLE_WINDOW, pba.SETTLE_RTOL)
    torch.cuda.synchronize(kl.device)
    return out
