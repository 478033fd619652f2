"""K2's plain twin (the port's cost volume) against the JAX package's Pallas
cost volume, run in interpret mode on the CPU.

The same numpy inputs go to ``pallas_cost_volume_right_ssd(...,
interpret=True)`` and to the port's wrapper ``cuda_cost_volume.cost_volume``,
which takes the plain twin for CPU tensors. Window sums of the
integer-valued ``_random_stereo`` images are exact in float32 in any order,
so the volumes must agree bit for bit, +inf pattern included. K2 itself
needs the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu.ops.pallas_cost_volume import pallas_cost_volume_right_ssd
from stereo_reconstruction_tpu_torch.kernels.launch import LAUNCHES
from stereo_reconstruction_tpu_torch.ops import block_search as tbs
from stereo_reconstruction_tpu_torch.ops import cuda_cost_volume as ccv
from stereo_reconstruction_tpu_torch.config import MatcherConfig

from test_block_search import _random_stereo

torch.set_num_threads(1)

# (h, w, extra left columns, min_d, max_d, block)
CASES = [
    (24, 32, 0, 0, 10, 7),
    (21, 40, 9, 2, 12, 5),
]


def _pair(rng, h, w, extra):
    left, right = _random_stereo(rng, h=h, w=w, max_d=8)
    return np.pad(left, ((0, 0), (0, extra), (0, 0))), right


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.float32)


@pytest.mark.parametrize("h,w,extra,min_d,max_d,bs", CASES)
def test_twin_bit_equal_to_jax_pallas_volume(rng, h, w, extra, min_d, max_d, bs):
    left, right = _pair(rng, h, w, extra)
    want = np.asarray(pallas_cost_volume_right_ssd(
        jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32),
        block_size=bs, min_disparity=min_d, max_disparity=max_d, interpret=True))
    got = ccv.cost_volume(_t(left), _t(right), bs, min_d, max_d).numpy()
    assert got.shape == want.shape == (max_d - min_d, h, w)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    # tolerance: none — integer-valued window sums are exact in float32
    np.testing.assert_array_equal(got[finite], want[finite])


def test_wrapper_takes_twin_on_cpu_and_counts_no_launch(rng):
    left, right = _pair(rng, 21, 40, 9)
    k1, k2 = LAUNCHES["K1"], LAUNCHES["K2"]
    got = ccv.cost_volume(_t(left), _t(right), 5, 2, 12)
    want = ccv.cost_volume_right_ssd(_t(left), _t(right), 5, 2, 12)
    assert (LAUNCHES["K1"], LAUNCHES["K2"]) == (k1, k2) == (0, 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("wrapper", [ccv.cost_volume, ccv.matcher_inputs])
def test_negative_min_disparity_raises(rng, wrapper):
    left, right = _pair(rng, 12, 16, 0)
    with pytest.raises(ValueError, match="min_disparity"):
        wrapper(_t(left), _t(right), 5, -2, 6)


def test_block_search_refuses_negative_min_disparity_with_reason(rng):
    left, right = _pair(rng, 12, 16, 0)
    with pytest.raises(NotImplementedError, match="reference is wrong"):
        tbs.block_search_right(_t(left), _t(right),
                               MatcherConfig(block_size=5, min_disparity=-3,
                                             max_disparity=7))
