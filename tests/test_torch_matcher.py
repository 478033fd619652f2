"""The port's dense matcher against the JAX package on the CPU.

The port (``stereo_reconstruction_tpu_torch``) and the JAX reference get
the same numpy inputs. Window sums of the integer-valued ``_random_stereo``
images stay below 2^24, where float32 sums are exact in any order, so the
cost volume, the five smoothing-scan planes and the disparity must agree
bit for bit. K1 itself needs the card (tests/test_torch_cuda.py and
chip_smoke.py); on the CPU its wrapper takes the plain twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu import oracle
from stereo_reconstruction_tpu.config import MatcherConfig as JaxMatcherConfig
from stereo_reconstruction_tpu.ops import block_search as jbs
from stereo_reconstruction_tpu.ops import cost_volume as jcv
from stereo_reconstruction_tpu.ops import smoothing as jsm
from stereo_reconstruction_tpu_torch.config import MatcherConfig
from stereo_reconstruction_tpu_torch.kernels.launch import LAUNCHES
from stereo_reconstruction_tpu_torch.ops import block_search as tbs
from stereo_reconstruction_tpu_torch.ops import cost_volume as tcv
from stereo_reconstruction_tpu_torch.ops import cuda_cost_volume as ccv
from stereo_reconstruction_tpu_torch.ops import smoothing as tsm

from test_block_search import _random_stereo, _sequential_reference_smoothing_f32

torch.set_num_threads(1)

# (h, w, extra left columns, min_d, max_d, block) — min_d = 0 and 2, a
# left image wider than the right, H = 21 (not a multiple of 8)
CASES = [
    (24, 32, 0, 0, 10, 7),
    (21, 40, 9, 2, 12, 5),
    (21, 40, 9, 0, 10, 7),
]


def _pair(rng, h, w, extra):
    left, right = _random_stereo(rng, h=h, w=w, max_d=8)
    return np.pad(left, ((0, 0), (0, extra), (0, 0))), right


def _jax_volume(left, right, bs, min_d, max_d):
    return np.asarray(jcv.cost_volume_right_ssd(
        jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32),
        block_size=bs, min_disparity=min_d, max_disparity=max_d))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("h,w,extra,min_d,max_d,bs", CASES)
def test_cost_volume_bit_equal_to_jax(rng, h, w, extra, min_d, max_d, bs):
    left, right = _pair(rng, h, w, extra)
    want = _jax_volume(left, right, bs, min_d, max_d)
    got = tcv.cost_volume_right_ssd(_t(left), _t(right), bs, min_d, max_d).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    # tolerance: none — integer-valued window sums are exact in float32
    np.testing.assert_array_equal(got[finite], want[finite])


@pytest.mark.parametrize("h,w,extra,min_d,max_d,bs", CASES)
def test_twin_planes_bit_equal_to_jax_reductions(rng, h, w, extra, min_d, max_d, bs):
    left, right = _pair(rng, h, w, extra)
    want = jsm.volume_reductions(
        jnp.asarray(_jax_volume(left, right, bs, min_d, max_d)), min_d)
    got = ccv.matcher_inputs_plain(_t(left), _t(right), bs, min_d, max_d)
    for name, g, wv in zip(("m0", "a0", "c_zero", "diag_up", "diag_lf"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv), err_msg=name)
    assert got[1].dtype == torch.int32


def test_wrapper_takes_twin_on_cpu_and_counts_no_launch(rng):
    left, right = _pair(rng, 21, 40, 9)
    before = LAUNCHES["K1"]
    got = ccv.matcher_inputs(_t(left), _t(right), 5, 2, 12)
    want = ccv.matcher_inputs_plain(_t(left), _t(right), 5, 2, 12)
    assert LAUNCHES["K1"] == before == 0
    for g, wv in zip(got, want):
        assert torch.equal(g, wv)


def test_pallas_backend_on_cpu_tensors_raises(rng):
    left, right = _random_stereo(rng, h=12, w=16)
    with pytest.raises(ValueError, match="CUDA"):
        tbs.block_search_right(_t(left), _t(right),
                               MatcherConfig(block_size=5, max_disparity=6,
                                             backend="pallas"))


def test_auto_backend_resolves_to_plain_on_cpu():
    assert not tbs.use_kernel(MatcherConfig(), torch.device("cpu"))
    assert tbs.use_kernel(MatcherConfig(), torch.device("cuda"))
    assert not tbs.use_kernel(MatcherConfig(backend="xla"), torch.device("cuda"))


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_negative_min_disparity_not_ported(rng, backend):
    left, right = _random_stereo(rng, h=12, w=16)
    with pytest.raises(NotImplementedError):
        tbs.block_search_right(_t(left), _t(right),
                               MatcherConfig(block_size=5, min_disparity=-2,
                                             max_disparity=6, backend=backend))


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_block_search_right_equals_jax(rng, backend):
    left, right = _random_stereo(rng, h=28, w=40, max_d=8)
    kw = dict(block_size=7, min_disparity=0, max_disparity=10, smooth_factor=0.9)
    want = np.asarray(jbs.block_search_right(
        jnp.asarray(left), jnp.asarray(right), JaxMatcherConfig(**kw)))
    got = tbs.block_search_right(torch.from_numpy(left), torch.from_numpy(right),
                                 MatcherConfig(backend=backend, **kw)).numpy()
    np.testing.assert_array_equal(got, want)


def test_block_search_right_matches_loop_oracle(rng):
    left, right = _random_stereo(rng, h=28, w=40, max_d=8)
    want = oracle.block_search_right_loop(
        left, right, block_size=7, min_disparity=0, max_disparity=10,
        smooth_factor=0.9)
    got = tbs.block_search_right(
        torch.from_numpy(left), torch.from_numpy(right),
        MatcherConfig(block_size=7, min_disparity=0, max_disparity=10)).numpy()
    agree = np.mean(got == want)
    # the JAX package's own bound (tests/test_block_search.py)
    assert agree > 0.99, f"only {agree:.3%} pixels agree with the loop oracle"


def test_black_strip_gets_zero(rng):
    left, right = _random_stereo(rng)
    got = tbs.block_search_right(torch.from_numpy(left), torch.from_numpy(right),
                                 MatcherConfig(block_size=7, max_disparity=10))
    assert (got[:, :2] == 0).all()


def test_narrow_left_keeps_minus_x_sentinel():
    h, w = 12, 16
    left = np.full((h, 8, 3), 100, np.uint8)
    right = np.full((h, w, 3), 100, np.uint8)
    want = oracle.block_search_right_loop(left, right, block_size=5,
                                          min_disparity=0, max_disparity=6)
    got = tbs.block_search_right(
        torch.from_numpy(left), torch.from_numpy(right),
        MatcherConfig(block_size=5, min_disparity=0, max_disparity=6)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, -1] == -(w - 1)).all()


@pytest.mark.parametrize("d_first", [0, 3])
def test_row_scan_exact_vs_sequential_recurrence(rng, d_first):
    """Exact ties, invalid columns and a cheap d=0 plane: the doubling
    composition of the 3-state automaton must equal the literal
    row-major recurrence."""
    D, h, w = 12, 17, 23
    cost = rng.uniform(0.1, 10.0, (D, h, w)).astype(np.float32)
    cost[rng.uniform(size=cost.shape) < 0.2] = np.inf
    cost[:, 3, 5:9] = np.inf
    cost[2] = cost[7]
    cost[0] = np.where(rng.uniform(size=(h, w)) < 0.3, 0.5, cost[0])
    black = rng.uniform(size=(h, w)) < 0.1
    want = _sequential_reference_smoothing_f32(cost, black, d_first=d_first)
    got = tsm.smoothed_argmin_reference(torch.from_numpy(cost),
                                        torch.from_numpy(black),
                                        smooth_factor=0.9, d_first=d_first)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w,wl,min_d,D,max_planes,match", [
    # K3's 16-bit plane indices: D = 65535 passes, 65536 names the limit
    (4, 8, 8, 0, 65535, 0xFFFF, None),
    (4, 8, 8, 0, 65536, 0xFFFF, "K3 takes D <= 65535"),
    # K1 and K2 have no plane limit of their own
    (4, 8, 8, 0, 70000, None, None),
    # the left layout: 3·H·WLp must stay below 2^31 - 1
    (1, 715827882, 715827882, 0, 0, None, None),
    (1, 715827883, 715827883, 0, 1, None, r"3·H·WLp < 2\^31 - 1"),
    (1000, 715000, 715000, 828, 10, None, r"3·1000·715838 = 2147514000"),
])
def test_kernel_limits_raise_value_error_before_launch(h, w, wl, min_d, D, max_planes,
                                                       match):
    """The wrappers' limits as ``ValueError`` naming the limit (the CUDA
    library would return cudaErrorInvalidValue), checked on the CPU."""
    kernel = "K3" if max_planes else "K1"
    if match is None:
        ccv.check_limits(h, w, wl, min_d, D, kernel, max_planes)
    else:
        with pytest.raises(ValueError, match=match):
            ccv.check_limits(h, w, wl, min_d, D, kernel, max_planes)
