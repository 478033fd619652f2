"""Numeric guards: the port's counterpart of the JAX package's checkify
sanitizers (``stereo_reconstruction_tpu/utils/debug.py``).

* ``checked(fn)`` wraps a function so that the ``guard`` / ``guard_finite``
  calls inside it check and raise ``CheckError``; with
  ``errors=FULL_CHECKS`` every floating-point tensor the function returns
  must be finite too (JAX instruments every float op; here a NaN or Inf
  the function produces is caught where it comes out);
* ``guard(pred, msg)`` / ``guard_finite(x, name)`` are free Python no-ops
  outside ``checked``, through the same ``contextvars`` switch as JAX's,
  so hot code keeps them in place. Under ``checked`` they read ``pred``
  or ``x`` on the host, a device sync that happens only under the switch.

Out-of-bounds indexing needs no guard: PyTorch raises on it (a device
assert on the card), where XLA would clamp.

Usage:
    from stereo_reconstruction_tpu_torch.utils import debug
    safe = debug.checked(my_fn)
    out = safe(*args)          # raises debug.CheckError on a failed guard
"""

from __future__ import annotations

import contextvars
import functools
from typing import Callable

import torch

# set while a function runs under ``checked``; guards are no-ops otherwise
_ACTIVE = contextvars.ContextVar("stpu_torch_checks_active", default=False)

USER_CHECKS = "user"    # the explicit guard() / guard_finite() calls
FULL_CHECKS = "full"    # and every floating-point output finite


class CheckError(RuntimeError):
    """A guard failed under ``checked``."""


def guard(pred, msg: str, **fmt) -> None:
    """Explicit invariant check: raise ``CheckError(msg.format(**fmt))``
    where ``pred`` is false. No-op unless running under ``checked``."""
    if _ACTIVE.get() and not bool(pred):
        raise CheckError(msg.format(**fmt))


def guard_finite(x, name: str = "value") -> None:
    """Every element of ``x`` finite (the classic cost-volume failure: a
    NaN window cost poisoning the argmin). No-op outside ``checked``."""
    if _ACTIVE.get() and not bool(torch.isfinite(torch.as_tensor(x)).all()):
        raise CheckError(f"{name} contains NaN/Inf")


def _float_tensors(out):
    if torch.is_tensor(out):
        if out.is_floating_point():
            yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _float_tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _float_tensors(v)


def checked(fn: Callable, errors: str = USER_CHECKS) -> Callable:
    """``fn`` with its guards active; ``errors=FULL_CHECKS`` also raises
    where a floating-point output holds a NaN or Inf. FULL_CHECKS trips on
    intentional non-finite sentinels too (the cost volumes use +inf =
    invalid), so it is for functions that should be sentinel-free."""
    if errors not in (USER_CHECKS, FULL_CHECKS):
        raise ValueError(f"errors must be USER_CHECKS or FULL_CHECKS, got {errors!r}")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        token = _ACTIVE.set(True)
        try:
            out = fn(*args, **kwargs)
        finally:
            _ACTIVE.reset(token)
        if errors == FULL_CHECKS:
            for i, t in enumerate(_float_tensors(out)):
                if not bool(torch.isfinite(t).all()):
                    kind = "nan" if bool(torch.isnan(t).any()) else "inf"
                    raise CheckError(f"{kind} in output {i} of {fn.__name__}")
        return out

    return wrapper
