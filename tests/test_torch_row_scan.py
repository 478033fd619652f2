"""K1b's wrapper, the exact smoothing row scan, against the JAX package on
the CPU, and the entry points' default device.

``ops/cuda_row_scan.py::row_scan`` takes its plain twin for CPU tensors
(K1b itself needs the card: tests/test_torch_cuda.py and chip_smoke.py).
The same numpy volume goes through JAX's ``volume_reductions`` and
``smoothed_argmin_from_inputs`` and through the port's; the scan is selects
and float32 products only, so the disparity must agree bit for bit
(tolerance: none). The volumes come from ``chip_smoke.scan_volume``, which
plants the zeros, sentinels, black pixels and ties the automaton turns on.
"""

import inspect
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu.ops import smoothing as jsm
from stereo_reconstruction_tpu_torch import pipeline as tpipe
from stereo_reconstruction_tpu_torch.config import MatcherConfig
from stereo_reconstruction_tpu_torch.data.records import StereoPair
from stereo_reconstruction_tpu_torch.ops import block_search as tbs
from stereo_reconstruction_tpu_torch.ops import cuda_row_scan as crs
from stereo_reconstruction_tpu_torch.ops import smoothing as tsm

from test_block_search import _random_stereo

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import scan_volume  # noqa: E402

torch.set_num_threads(1)

D = 12


def _jax_scan(cost, black, sf, d_first):
    planes = jsm.volume_reductions(jnp.asarray(cost), d_first)
    return np.asarray(jsm.smoothed_argmin_from_inputs(
        *planes, jnp.asarray(black), smooth_factor=sf, d_first=d_first,
        n_planes=cost.shape[0]))


@pytest.mark.parametrize("sf,ties", [(0.9, False), (1.0, True)])
@pytest.mark.parametrize("w", [1, 33, 1100])
@pytest.mark.parametrize("d_first", [0, 2])
def test_row_scan_equals_jax(d_first, w, sf, ties):
    rng = np.random.default_rng(w + 10 * d_first)
    cost, black = scan_volume(rng, 4 if w > 100 else 9, w, D, ties)
    want = _jax_scan(cost, black, sf, d_first)
    planes = tsm.volume_reductions(torch.from_numpy(cost), d_first)
    got = crs.row_scan(*planes, torch.from_numpy(black), smooth_factor=sf,
                       d_first=d_first, n_planes=D)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_scan_on_cpu_makes_no_launch():
    cost, black = scan_volume(np.random.default_rng(0), 6, 40, D)
    planes = tsm.volume_reductions(torch.from_numpy(cost), 0)
    before = crs.LAUNCHES
    got = crs.row_scan(*planes, torch.from_numpy(black), n_planes=D)
    want = tsm.smoothed_argmin_from_inputs(*planes, torch.from_numpy(black), n_planes=D)
    assert crs.LAUNCHES == before == 0
    assert torch.equal(got, want)


def test_kernel_branch_goes_through_row_scan(monkeypatch):
    """block_search_right's kernel branch is K1, then K1b (on the CPU both
    wrappers take their twins, so the branch can be driven here)."""
    left, right = _random_stereo(np.random.default_rng(0), h=28, w=40, max_d=8)
    L, R = torch.from_numpy(left), torch.from_numpy(right)
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        return crs.smoothed_argmin_from_inputs(*args, **kw)

    cfg = MatcherConfig(block_size=7, max_disparity=10)
    want = tbs.block_search_right(L, R, cfg)                 # auto on CPU: plain
    monkeypatch.setattr(tbs, "use_kernel", lambda config, device: True)
    monkeypatch.setattr(crs, "row_scan", spy)
    got = tbs.block_search_right(L, R, cfg)
    assert len(calls) == 1 and calls[0]["n_planes"] == 10
    assert torch.equal(got, want)


@pytest.mark.parametrize("entry", ["run_pair", "estimate_pose", "reconstruct_from_disparity"])
def test_entry_points_default_to_the_card(entry):
    fn = getattr(tpipe, entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return                  # the card tests drive them there
    K = np.array([[32.0, 0, 16], [0, 32, 12], [0, 0, 1]], np.float32)
    img = np.zeros((24, 32, 3), np.uint8)
    pair = StereoPair(img, img, K, K, name="none")
    args = (pair, np.zeros((24, 32), np.float32)) if entry == "reconstruct_from_disparity" \
        else (pair,)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(*args)
