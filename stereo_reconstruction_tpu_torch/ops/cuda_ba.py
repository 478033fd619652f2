"""The pose layer's bundle-adjustment kernel (``csrc/ba.cuh``) and its launcher.

The kernel replaces no TPU kernel (JAX's ``pose/ba.py`` is plain jnp). It
makes ``pose/ba.py::bundle_adjust`` of a batch of problems one launch, a
CTA a problem and a thread a point, the whole Levenberg-Marquardt solve in
registers and shared memory. The plain twin, ``pose/ba.py::
bundle_adjust_plain``, is ~21,800 small ops a solve of 20 steps.

``bundle_adjust`` takes B pairs (observations, intrinsics, weights) with S
starts each (R, T and the points) and writes the ``BAResult`` fields, each
with leading dimensions (B, S), into ``out`` where given (the CUDA graph
path, ``pose/graphs.py``); it neither synchronises nor reads the device.
``bundle_adjust_op`` (``torch.ops.stpu.bundle_adjust``) is one pair's
call as a custom op whose ``vmap`` rule makes the whole batch one launch,
for ``run_batch``'s vmapped pose stage. ``pose/ba.py::bundle_adjust_starts``
picks the route by the inputs' device and calls the op for inputs on one
CUDA device only; ``bundle_adjust`` launches or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from stereo_reconstruction_tpu_torch.config import BundleAdjustmentConfig
from stereo_reconstruction_tpu_torch.kernels.launch import entry, launch

_p, _i = ctypes.c_void_p, ctypes.c_int
_ba = entry("stpu_ba", [_p, _p, _p, _p], _i)
_max_points = entry("stpu_ba_max_points", [], _i)

LOSSES = ("huber", "l2")


def result_buffers(batch: Tuple[int, ...], n: int, device) -> Tuple[torch.Tensor, ...]:
    """Empty ``BAResult`` fields for N points with leading dimensions
    ``batch``, in its field order."""
    def empty(*shape, dtype=torch.float32):
        return torch.empty((*batch, *shape), dtype=dtype, device=device)

    return (empty(3, 3), empty(3), empty(4, 4), empty(3, n), empty(), empty(), empty(3, 3),
            empty(dtype=torch.bool))


def check_config(config: BundleAdjustmentConfig):
    """Raise ValueError where the kernel does not take ``config``: at most
    ``stpu_ba_max_points()`` points (a thread each in one CTA), a Huber or
    L2 loss and no negative step count."""
    points = _max_points()
    if not (1 <= config.num_points <= points and config.loss in LOSSES
            and config.max_iterations >= 0):
        raise ValueError(f"the BA kernel takes 1 <= num_points <= {points}, a loss in {LOSSES} "
                         f"and max_iterations >= 0; got num_points {config.num_points}, loss "
                         f"{config.loss!r}, max_iterations {config.max_iterations}")


def check(kl, kr, K_left, K_right, w, R0, T0, X0, config: BundleAdjustmentConfig):
    """Raise ValueError on what the kernel does not take."""
    if kl.ndim != 3 or kl.shape[1] != 3 or kr.shape != kl.shape:
        raise ValueError(f"observations must be (B, 3, N), got {tuple(kl.shape)} and "
                         f"{tuple(kr.shape)}")
    b, _, n = kl.shape
    s = R0.shape[1] if R0.ndim == 4 else 0
    want = {"K_left": (K_left, (b, 3, 3)), "K_right": (K_right, (b, 3, 3)),
            "weights": (w, (b, n)), "rotations": (R0, (b, s, 3, 3)),
            "translations": (T0, (b, s, 3)), "points": (X0, (b, s, 3, n))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("matches_left", kl), ("matches_right", kr)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    check_config(dataclasses.replace(config, num_points=n))
    if s < 1 or b * s > 2 ** 31 - 1:
        raise ValueError(f"the BA kernel takes 1 to 2**31 - 1 problems, got {b} x {s}")


def call(kl, kr, K_left, K_right, w, R0, T0, X0, config: BundleAdjustmentConfig, window: int,
         rtol: float, out: Sequence[torch.Tensor], stream) -> int:
    """``stpu_ba`` on contiguous tensors of one device; its return code."""
    b, _, n = kl.shape
    tensors = (kl, kr, K_left, K_right, w, R0, T0, X0, *out)
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    dims = (ctypes.c_int * 6)(b, R0.shape[1], n, config.max_iterations, window,
                              int(config.loss == "huber"))
    scalars = (ctypes.c_float * 7)(config.huber_delta, config.init_lambda, config.lambda_up,
                                   config.lambda_down, config.min_lambda, config.max_lambda,
                                   rtol)
    return _ba(ptrs, dims, scalars, stream)


def bundle_adjust(kl: torch.Tensor, kr: torch.Tensor, K_left: torch.Tensor,
                  K_right: torch.Tensor, w: torch.Tensor, R0: torch.Tensor, T0: torch.Tensor,
                  X0: torch.Tensor, config: BundleAdjustmentConfig, window: int, rtol: float,
                  out: Optional[Sequence[torch.Tensor]] = None) -> Tuple[torch.Tensor, ...]:
    """``pose/ba.py::bundle_adjust`` of B pairs from S starts each on the
    card, one launch on the current stream: (B, 3, N) float32 observations,
    (B, 3, 3) intrinsics, (B, N) weights, (B, S, 3, 3) rotations, (B, S, 3)
    translations and (B, S, 3, N) points, all on one CUDA device, and the
    convergence test's window and tolerance (``pose/ba.py``'s
    ``SETTLE_WINDOW``, ``SETTLE_RTOL``). Returns the ``BAResult`` fields with
    leading (B, S), written into ``out`` (``result_buffers``) where given."""
    tensors = (kl, kr, K_left, K_right, w, R0, T0, X0)
    check(*tensors, config)
    tensors = tuple(t.contiguous() for t in tensors)
    b, _, n = kl.shape
    if out is None:
        out = result_buffers((b, R0.shape[1]), n, kl.device)
    launch("ba", call, kl.device, *tensors, config, window, rtol, out)
    return tuple(out)


def _op_config(max_iterations, loss, huber_delta, init_lambda, lambda_up, lambda_down,
               min_lambda, max_lambda):
    """The ``BundleAdjustmentConfig`` whose fields the custom op takes as
    arguments."""
    return BundleAdjustmentConfig(max_iterations=max_iterations, loss=loss,
                                  huber_delta=huber_delta, init_lambda=init_lambda,
                                  lambda_up=lambda_up, lambda_down=lambda_down,
                                  min_lambda=min_lambda, max_lambda=max_lambda)


@torch.library.custom_op("stpu::bundle_adjust", mutates_args=())
def bundle_adjust_op(kl: torch.Tensor, kr: torch.Tensor, K_left: torch.Tensor,
                     K_right: torch.Tensor, w: torch.Tensor, R0: torch.Tensor, T0: torch.Tensor,
                     X0: torch.Tensor, max_iterations: int, loss: str, huber_delta: float,
                     init_lambda: float, lambda_up: float, lambda_down: float,
                     min_lambda: float, max_lambda: float, window: int, rtol: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pair's ``bundle_adjust``: (3, N) observations, (3, 3) intrinsics,
    (N,) weights and S starts, (S, 3, 3), (S, 3), (S, 3, N); the
    ``BAResult`` fields with a leading S."""
    config = _op_config(max_iterations, loss, huber_delta, init_lambda, lambda_up, lambda_down,
                        min_lambda, max_lambda)
    out = result_buffers((R0.shape[0],), kl.shape[-1], kl.device)
    bundle_adjust(kl[None], kr[None], K_left[None], K_right[None], w[None], R0[None], T0[None],
                  X0[None], config, window, rtol, [x[None] for x in out])
    return out


def _vmap_rule(info, in_dims, kl, kr, K_left, K_right, w, R0, T0, X0, *args):
    """The batch of a ``vmap`` as one ``bundle_adjust`` call: inputs without
    a batch dimension are expanded to it."""
    def batched(x, dim):
        return x.movedim(dim, 0) if dim is not None else x.expand(info.batch_size, *x.shape)

    tensors = [batched(x, d) for x, d in zip((kl, kr, K_left, K_right, w, R0, T0, X0), in_dims)]
    *fields, window, rtol = args
    return bundle_adjust(*tensors, _op_config(*fields), window, rtol), (0,) * 8


torch.library.register_vmap(bundle_adjust_op, _vmap_rule)
