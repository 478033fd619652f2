"""The pose layer's RANSAC kernel (``csrc/ransac.cuh``) and its launcher.

The kernel replaces no TPU kernel (JAX's ``pose/ransac.py`` is plain jnp).
It makes ``pose/ransac.py::ransac_eight_point`` of one pair, or of a batch
of pairs, two launches: one warp per hypothesis (the sample, the
eight-point solve, its pixel error, F's inliers and ``match_fit``), then
one warp per pair (the winner, the best fitting hypothesis and the
refits). The plain twin, ``pose/ransac.py``, is ~45,000 small ops a call.

``ransac`` takes a leading batch dimension and writes the ``RansacResult``
fields, each with that dimension, into ``out`` where given (the CUDA graph
path, ``pose/graphs.py``); it neither synchronises nor reads the device.
``ransac_eight_point_op`` (``torch.ops.stpu.ransac_eight_point``) is one
pair's call as a custom op whose ``vmap`` rule makes one launch pair of
the whole batch, for ``run_batch``'s vmapped pose stage.
``pose/ransac.py::ransac_eight_point`` picks the route by the inputs'
device and calls the op for inputs on one CUDA device only; ``ransac``
launches or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from stereo_reconstruction_tpu_torch.config import RansacConfig
from stereo_reconstruction_tpu_torch.kernels.launch import entry, launch

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ransac = entry("stpu_ransac", [_p, _p, _f, _f, _p], _i)
_max_points = entry("stpu_ransac_max_points", [], _i)
# the most matches a pair may have with no key scratch
shared_keys = entry("stpu_ransac_shared_keys", [], _i)
_hyp_floats = entry("stpu_ransac_hyp_floats", [], _i)
_hyp_ints = entry("stpu_ransac_hyp_ints", [], _i)


def result_buffers(batch: Tuple[int, ...], support: int, device) -> Tuple[torch.Tensor, ...]:
    """Empty ``RansacResult`` fields with leading dimensions ``batch``, in
    its field order."""
    def empty(*shape, dtype=torch.float32):
        return torch.empty((*batch, *shape), dtype=dtype, device=device)

    return (empty(3, 3), empty(3), empty(3, 3), empty(4, 4), empty(support, dtype=torch.int64),
            empty(dtype=torch.int64), empty(), empty(dtype=torch.bool),
            empty(dtype=torch.bool), empty(4, 4), empty())


def scratch_buffers(batch: int, config: RansacConfig, n: int,
                    device) -> Tuple[torch.Tensor, ...]:
    """The kernel's scratch: each hypothesis's floats (R, T, E, mean error,
    match fit) and ints (inliers or -1, valid, all below, its sample), each
    pair's winner and best fitting hypothesis, and, where N matches are more
    than shared memory holds, the refits' (B, N) sort keys."""
    k = config.num_hypotheses
    keys = n if n > shared_keys() else 0
    return (torch.empty((batch, k, _hyp_floats()), dtype=torch.float32, device=device),
            torch.empty((batch, k, _hyp_ints() + config.sample_size),
                        dtype=torch.int32, device=device),
            torch.empty((batch, 2), dtype=torch.int32, device=device),
            torch.empty((batch, keys), dtype=torch.int32, device=device))


def support_of(config: RansacConfig, n: int) -> int:
    return min(config.refine_support, n)


def check(ml, mr, K_left, K_right, n_valid, u, config: RansacConfig):
    """Raise ValueError on what the kernel does not take."""
    if ml.ndim != 3 or ml.shape[1] != 3 or mr.shape != ml.shape:
        raise ValueError(f"matches must be (B, 3, N), got {tuple(ml.shape)} and "
                         f"{tuple(mr.shape)}")
    b, _, n = ml.shape
    k = config.num_hypotheses
    want = {"K_left": (K_left, (b, 3, 3)), "K_right": (K_right, (b, 3, 3)),
            "n_valid": (n_valid, (b,)), "uniforms": (u, (b, k, n))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("matches_left", ml), ("matches_right", mr), ("K_left", K_left),
                    ("K_right", K_right), ("uniforms", u)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if n_valid.dtype != torch.int64:
        raise ValueError(f"n_valid must be int64, got {n_valid.dtype}")
    check_config(config, n)
    if not 1 <= b <= 65535:
        raise ValueError(f"the RANSAC kernel takes 1 to 65535 pairs a call, got {b}")


def check_config(config: RansacConfig, n: int):
    """Raise ValueError where the kernel does not take ``config`` on N
    matches: sample_size and refine_support (points a warp holds, one a
    lane) at most ``stpu_ransac_max_points()``, sample_size at most N."""
    s, support = config.sample_size, support_of(config, n)
    points = _max_points()
    if not (1 <= s <= min(n, points) and 1 <= support <= points
            and config.num_hypotheses >= 1 and config.refine_rounds >= 0):
        raise ValueError(f"the RANSAC kernel takes 1 <= sample_size <= min(N, {points}), "
                         f"refine_support <= {points}, num_hypotheses >= 1 and "
                         f"refine_rounds >= 0; got sample_size {s}, N {n}, refine_support "
                         f"{config.refine_support}, num_hypotheses {config.num_hypotheses}, "
                         f"refine_rounds {config.refine_rounds}")


def call(ml, mr, K_left, K_right, n_valid, u, config: RansacConfig,
         out: Sequence[torch.Tensor], scratch: Sequence[torch.Tensor], stream) -> int:
    """``stpu_ransac`` on contiguous tensors of one device; its return code."""
    b, _, n = ml.shape
    tensors = (ml, mr, K_left, K_right, n_valid, u, *scratch, *out)
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    dims = (ctypes.c_int * 6)(b, n, config.num_hypotheses, config.sample_size,
                              config.refine_rounds, support_of(config, n))
    return _ransac(ptrs, dims, float(config.error_threshold),
                   float(config.error_threshold ** 2), stream)


def ransac(ml: torch.Tensor, mr: torch.Tensor, K_left: torch.Tensor, K_right: torch.Tensor,
           n_valid: torch.Tensor, u: torch.Tensor, config: RansacConfig = RansacConfig(),
           out: Optional[Sequence[torch.Tensor]] = None,
           scratch: Optional[Sequence[torch.Tensor]] = None) -> Tuple[torch.Tensor, ...]:
    """``ransac_eight_point`` of B pairs on the card, two launches on the
    current stream: (B, 3, N) float32 matches, (B, 3, 3) intrinsics, (B,)
    int64 valid counts and (B, num_hypotheses, N) uniforms, all on one CUDA
    device (``pose/ransac.py::ransac_eight_point`` routes only those here).
    Returns the ``RansacResult`` fields with a leading B, written into
    ``out`` (``result_buffers``) where given."""
    tensors = (ml, mr, K_left, K_right, n_valid, u)
    check(*tensors, config)
    ml, mr, K_left, K_right, n_valid, u = (t.contiguous() for t in tensors)
    b, _, n = ml.shape
    if out is None:
        out = result_buffers((b,), support_of(config, n), ml.device)
    if scratch is None:
        scratch = scratch_buffers(b, config, n, ml.device)
    launch("ransac", call, ml.device, ml, mr, K_left, K_right, n_valid, u, config, out,
           scratch, count=2)
    return tuple(out)


def _op_config(num_hypotheses, sample_size, error_threshold, refine_rounds, refine_support):
    """The ``RansacConfig`` whose fields the custom op takes as arguments."""
    return RansacConfig(num_hypotheses=num_hypotheses, sample_size=sample_size,
                        error_threshold=error_threshold, refine_rounds=refine_rounds,
                        refine_support=refine_support)


@torch.library.custom_op("stpu::ransac_eight_point", mutates_args=())
def ransac_eight_point_op(ml: torch.Tensor, mr: torch.Tensor, K_left: torch.Tensor,
                          K_right: torch.Tensor, n_valid: torch.Tensor, u: torch.Tensor,
                          num_hypotheses: int, sample_size: int, error_threshold: float,
                          refine_rounds: int, refine_support: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pair's ``ransac``: (3, N) matches, (3, 3) intrinsics, a 0-d
    int64 valid count, (num_hypotheses, N) uniforms; the ``RansacResult``
    fields."""
    config = _op_config(num_hypotheses, sample_size, error_threshold, refine_rounds,
                        refine_support)
    out = result_buffers((), support_of(config, ml.shape[-1]), ml.device)
    ransac(ml[None], mr[None], K_left[None], K_right[None], n_valid.reshape(1), u[None],
           config, [x[None] for x in out])
    return out


def _vmap_rule(info, in_dims, ml, mr, K_left, K_right, n_valid, u, num_hypotheses,
               sample_size, error_threshold, refine_rounds, refine_support):
    """The batch of a ``vmap`` as one ``ransac`` call: inputs without a
    batch dimension are expanded to it."""
    def batched(x, dim):
        return x.movedim(dim, 0) if dim is not None else x.expand(info.batch_size, *x.shape)

    args = [batched(x, d) for x, d in zip((ml, mr, K_left, K_right, n_valid, u), in_dims)]
    config = _op_config(num_hypotheses, sample_size, error_threshold, refine_rounds,
                        refine_support)
    return ransac(*args, config), (0,) * 11


torch.library.register_vmap(ransac_eight_point_op, _vmap_rule)
