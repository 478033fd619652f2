"""K1b's wrapper, the exact smoothing row scan, against the JAX package on
the CPU, and the entry points' default device.

``ops/cuda_row_scan.py::row_scan`` takes its plain twin for CPU tensors
(K1b itself needs the card: tests/test_torch_cuda.py and chip_smoke.py).
The same numpy volume goes through JAX's ``volume_reductions`` and
``smoothed_argmin_from_inputs`` and through the port's; the scan is selects
and float32 products only, so the disparity must agree bit for bit
(tolerance: none). The volumes come from ``torch_helpers.scan_volume``,
which plants the zeros, sentinels, black pixels and ties the automaton
turns on; ``torch_helpers.chain_planes`` plants runs whose every pixel the
entering case decides (K1b hands that case from strip to strip), and
rows wider than 4096 columns are held to JAX too.
"""

import inspect

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
from torch_helpers import chain_planes, scan_volume, seed_rows

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


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("d_first", [0, 2])
def test_reference_takes_jax_parameters_positionally(d_first, seeded):
    """(cost, black, smooth_factor, iters, d_first, first_flags,
    init_prev) in JAX's order: iters is ignored, the seeds pass through."""
    rng = np.random.default_rng(40 + d_first + 2 * seeded)
    cost, black = scan_volume(rng, 9, 70, D)
    first, seed = seed_rows(rng, 9, 70, D) if seeded else (None, None)

    def conv(a, mod):
        return None if a is None else mod(a)

    want = np.asarray(jsm.smoothed_argmin_reference(
        jnp.asarray(cost), jnp.asarray(black), 0.9, 3, d_first,
        conv(first, jnp.asarray), conv(seed, jnp.asarray)))
    got = tsm.smoothed_argmin_reference(
        torch.from_numpy(cost), torch.from_numpy(black), 0.9, 3, d_first,
        conv(first, torch.from_numpy), conv(seed, torch.from_numpy))
    np.testing.assert_array_equal(got.numpy(), want)
    if not seeded:
        np.testing.assert_array_equal(got.numpy(), _jax_scan(cost, black, 0.9, d_first))


def test_reference_refuses_negative_d_first():
    cost, black = scan_volume(np.random.default_rng(0), 3, 20, D)
    with pytest.raises(ValueError, match="iters=None"):
        tsm.smoothed_argmin_reference(torch.from_numpy(cost), torch.from_numpy(black),
                                      0.9, 2, -1)


@pytest.mark.parametrize("w", [4097, 6000])
def test_row_scan_past_4096_columns_equals_jax(w):
    rng = np.random.default_rng(w)
    cost, black = scan_volume(rng, 3, w, D, ties=w % 2 == 1)
    want = _jax_scan(cost, black, 0.9, 1)
    planes = tsm.volume_reductions(torch.from_numpy(cost), 1)
    got = crs.row_scan(*planes, torch.from_numpy(black), smooth_factor=0.9, d_first=1,
                       n_planes=D)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("h,w,sf,ties,d_first", [
    (1, 1, 0.9, False, 0),
    (2, 65, 1.0, True, 0),
    (6, 700, 0.9, False, 0),
    (5, 1408, 1.0, True, 1),
    (3, 4097, 0.9, False, 2),
])
def test_twin_equals_jax_on_chain_planes(h, w, sf, ties, d_first, seeded):
    rng = np.random.default_rng(h * 7919 + w + seeded)
    *planes, black = chain_planes(rng, h, w, D, ties)
    first, seed = seed_rows(rng, h, w, D) if seeded else (None, None)
    want = np.asarray(jsm.smoothed_argmin_from_inputs(
        *(jnp.asarray(p) for p in planes), jnp.asarray(black), smooth_factor=sf,
        d_first=d_first, n_planes=D,
        first_flags=None if first is None else jnp.asarray(first),
        init_prev=None if seed is None else jnp.asarray(seed)))
    got = tsm.smoothed_argmin_from_inputs(
        *(torch.from_numpy(p) for p in planes), torch.from_numpy(black), smooth_factor=sf,
        d_first=d_first, n_planes=D,
        first_flags=None if first is None else torch.from_numpy(first),
        init_prev=None if seed is None else torch.from_numpy(seed))
    np.testing.assert_array_equal(got.numpy(), want)


def test_chain_planes_hinge_on_the_entering_case():
    """On chain planes one pixel's case reaches far to its right: forcing
    column 299 of every row black (case 'chose 0') changes pixels beyond
    the next 64-column boundary, as a wrong case handed across a strip
    boundary would."""
    rng = np.random.default_rng(5)
    *planes, black = (torch.from_numpy(a) for a in chain_planes(rng, 8, 1200, D))
    kicked = black.clone()
    kicked[:, 299] = ~black[:, 299]
    whole = tsm.smoothed_argmin_from_inputs(*planes, black, n_planes=D)
    moved = tsm.smoothed_argmin_from_inputs(*planes, kicked, n_planes=D)
    assert int((whole[:, 384:] != moved[:, 384:]).sum()) >= 64


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
