"""The port's dense matcher variants against the JAX package on the CPU.

The SAD, NCC and Left-SSD volumes, the fixpoint smoother
(``smoothing.smoothed_argmin``) and ``plain_argmin``, the texture measure
of the variable block, ``block_search_right`` with ``cost="sad" | "ncc"``
and ``var_block=True``, ``block_search_left`` and ``linear_search`` get the
same numpy inputs in both packages. The volumes are held to the JAX tests'
tolerance (rtol 1e-5, atol 1e-4, ``tests/test_block_search.py``); the
disparities, texture and smoother outputs must be equal, and the Left and
linear searches also meet the JAX tests' bounds against the loop oracle.
On the CPU the SAD, NCC and var-block routes take K1b's plain twin; the
card runs them in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu import oracle
from stereo_reconstruction_tpu.config import MatcherConfig as JaxMatcherConfig
from stereo_reconstruction_tpu.ops import block_search as jbs
from stereo_reconstruction_tpu.ops import cost_volume as jcv
from stereo_reconstruction_tpu.ops import linear_search as jls
from stereo_reconstruction_tpu.ops import smoothing as jsm
from stereo_reconstruction_tpu_torch.config import MatcherConfig
from stereo_reconstruction_tpu_torch.kernels.launch import LAUNCHES
from stereo_reconstruction_tpu_torch.ops import block_search as tbs
from stereo_reconstruction_tpu_torch.ops import cost_volume as tcv
from stereo_reconstruction_tpu_torch.ops import linear_search as tls
from stereo_reconstruction_tpu_torch.ops import smoothing as tsm

from test_block_search import _random_stereo, _sequential_smoothing_any_mode

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _planted_volume(rng, D=8, h=12, w=18):
    """Small integer costs (many exact ties, long smoothing chains), +inf
    entries, a row of whole-invalid columns, and black pixels."""
    cost = rng.integers(0, 4, (D, h, w)).astype(np.float32) + 1.0
    cost[rng.uniform(size=cost.shape) < 0.15] = np.inf
    cost[:, 2, 4:7] = np.inf
    return cost, rng.uniform(size=(h, w)) < 0.1


@pytest.mark.parametrize("iters", [None, 2])
@pytest.mark.parametrize("variant", ["right", "left"])
@pytest.mark.parametrize("mode", ["reference", "intended", "none"])
def test_smoothed_argmin_equals_jax(rng, mode, variant, iters):
    for trial in range(2):
        cost, black = _planted_volume(rng)
        dvals = np.arange(1, cost.shape[0] + 1, dtype=np.float32)
        want = np.asarray(jsm.smoothed_argmin(
            jnp.asarray(cost), jnp.asarray(dvals), jnp.asarray(black), smooth_factor=0.9,
            mode=mode, iters=iters, variant=variant))
        got = tsm.smoothed_argmin(_t(cost), _t(dvals), _t(black), smooth_factor=0.9,
                                  mode=mode, iters=iters, variant=variant).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
        if mode == "none":
            # no discount: the winner-take-all argmin
            np.testing.assert_array_equal(got, np.asarray(jsm.plain_argmin(
                jnp.asarray(cost), jnp.asarray(dvals), jnp.asarray(black), variant)))
        elif iters is None:
            # the fixpoint is the literal row-major recurrence
            np.testing.assert_array_equal(got, _sequential_smoothing_any_mode(
                cost, black, sf=0.9, mode=mode, variant=variant, dvals=dvals))


@pytest.mark.parametrize("mode,variant", [("reference", "right"), ("reference", "left"),
                                          ("intended", "right"), ("intended", "left")])
def test_fixpoint_on_wide_rows_equals_jax_and_the_recurrence(rng, mode, variant):
    """Wide rows with few candidates give long in-row smoothing chains, so
    the fixpoint takes many sweeps; it still equals JAX's while loop and
    the literal row-major recurrence."""
    cost, black = _planted_volume(rng, D=10, h=9, w=40)
    dvals = np.arange(10, dtype=np.float32)
    want = np.asarray(jsm.smoothed_argmin(
        jnp.asarray(cost), jnp.asarray(dvals), jnp.asarray(black), mode=mode,
        iters=None, variant=variant))
    got = tsm.smoothed_argmin(_t(cost), _t(dvals), _t(black), mode=mode, iters=None,
                              variant=variant).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _sequential_smoothing_any_mode(
        cost, black, sf=0.9, mode=mode, variant=variant, dvals=dvals))


@pytest.mark.parametrize("variant", ["right", "left"])
def test_plain_argmin_equals_jax(rng, variant):
    cost, black = _planted_volume(rng)
    dvals = np.arange(3, 3 + cost.shape[0], dtype=np.float32)
    want = np.asarray(jsm.plain_argmin(jnp.asarray(cost), jnp.asarray(dvals),
                                       jnp.asarray(black), variant=variant))
    got = tsm.plain_argmin(_t(cost), _t(dvals), _t(black), variant=variant).numpy()
    np.testing.assert_array_equal(got, want)


# (h, w, extra left columns, block, min_d, max_d)
VOLUME_CASES = [(24, 32, 0, 7, 0, 10), (21, 40, 9, 5, 2, 12)]


@pytest.mark.parametrize("case", VOLUME_CASES)
@pytest.mark.parametrize("cost", ["sad", "ncc", "left_ssd"])
def test_volume_equals_jax(rng, cost, case):
    h, w, extra, bs, min_d, max_d = case
    left, right = _random_stereo(rng, h=h, w=w, max_d=8)
    left = np.pad(left, ((0, 0), (0, extra), (0, 0)))
    if cost == "left_ssd":
        want = np.asarray(jcv.cost_volume_left_ssd(_j(left), _j(right), bs, max_d))
        got = tcv.cost_volume_left_ssd(_t(left), _t(right), bs, max_d).numpy()
    else:
        args = (bs, min_d, max_d)
        want = np.asarray(getattr(jcv, f"cost_volume_right_{cost}")(_j(left), _j(right),
                                                                    *args))
        got = getattr(tcv, f"cost_volume_right_{cost}")(_t(left), _t(right), *args).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    assert finite.any()
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("block_size", [5, 7])
def test_window_texture_equals_jax_and_the_oracle(rng, block_size):
    _, right = _random_stereo(rng, h=16, w=20)
    want = np.asarray(jbs.window_texture(_j(right), block_size))
    got = tbs.window_texture(_t(right), block_size).numpy()
    np.testing.assert_array_equal(got, want)
    hbs = (block_size - 1) // 2
    for y, x in [(0, 0), (3, 4), (8, 10), (15, 19)]:
        l, r = min(x, hbs), min(20 - x - 1, hbs)
        u, d = min(y, hbs), min(16 - y - 1, hbs)
        # the JAX test's tolerance against the float64 oracle
        np.testing.assert_allclose(got[y, x], oracle._texture(right, x, y, l, r, u, d),
                                   rtol=1e-4, atol=0.5)


RIGHT_VARIANTS = {
    "sad": dict(cost="sad"),
    "ncc": dict(cost="ncc"),
    # sizes and a threshold at which every size wins somewhere
    "var_block": dict(var_block=True, var_block_sizes=(5, 7, 9), texture_threshold=60.0),
}


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("variant", sorted(RIGHT_VARIANTS))
def test_block_search_right_variant_equals_jax(rng, variant, backend):
    left, right = _random_stereo(rng, h=24, w=40, max_d=8, noise=2)
    kw = dict(block_size=7, max_disparity=10, **RIGHT_VARIANTS[variant])
    want = np.asarray(jbs.block_search_right(jnp.asarray(left), jnp.asarray(right),
                                             JaxMatcherConfig(**kw)))
    before = LAUNCHES["K1b"]
    got = tbs.block_search_right(_t(left), _t(right),
                                 MatcherConfig(backend=backend, **kw)).numpy()
    assert LAUNCHES["K1b"] == before == 0          # the CPU takes K1b's plain twin
    np.testing.assert_array_equal(got, want)
    assert (got[:, :2] == 0).all()              # the black strip
    if variant == "var_block":
        sel = tbs._texture_select(_t(right).float(), (5, 7, 9), 60.0)
        assert set(sel.unique().tolist()) == {0, 1, 2}


@pytest.mark.parametrize("variant", sorted(RIGHT_VARIANTS))
def test_variant_routes_refuse_negative_min_disparity(rng, variant):
    left, right = _random_stereo(rng, h=12, w=16)
    with pytest.raises(NotImplementedError, match="min_disparity < 0"):
        tbs.block_search_right(_t(left), _t(right), MatcherConfig(
            block_size=5, min_disparity=-2, max_disparity=6, **RIGHT_VARIANTS[variant]))


def test_perceptual_cost_is_not_ported(rng):
    left, right = _random_stereo(rng, h=12, w=16)
    with pytest.raises(NotImplementedError, match="perceptual"):
        tbs.block_search_right(_t(left), _t(right), MatcherConfig(cost="perceptual"))


@pytest.mark.parametrize("h,w,bs,max_d", [(24, 36, 5, 8), (20, 30, 7, 6)])
def test_block_search_left_equals_jax_and_the_oracle(rng, h, w, bs, max_d):
    left, right = _random_stereo(rng, h=h, w=w, max_d=6)
    kw = dict(block_size=bs, max_disparity=max_d, smooth_factor=0.9)
    want = np.asarray(jbs.block_search_left(jnp.asarray(left), jnp.asarray(right),
                                            JaxMatcherConfig(**kw)))
    got = tbs.block_search_left(_t(left), _t(right), MatcherConfig(**kw)).numpy()
    np.testing.assert_array_equal(got, want)
    agree = np.mean(got == oracle.block_search_left_loop(
        left, right, block_size=bs, max_disparity=max_d, smooth_factor=0.9))
    # the JAX package's own bound (tests/test_block_search.py)
    assert agree > 0.97, f"only {agree:.3%} pixels agree with the loop oracle"


@pytest.mark.parametrize("search_range", [8, 13])
def test_linear_search_equals_jax_and_the_oracle(rng, search_range):
    h, w = 24, 40
    left = rng.integers(5, 250, (h, w, 3)).astype(np.uint8)
    right = np.roll(left, -3, axis=1)
    left[:, :2] = 0      # the black strip, tested on the LEFT image (quirk)
    want = np.asarray(jls.linear_search(jnp.asarray(left), jnp.asarray(right),
                                        smooth_factor=0.9, search_range=search_range))
    got = tls.linear_search(_t(left), _t(right), smooth_factor=0.9,
                            search_range=search_range).numpy()
    np.testing.assert_array_equal(got, want)
    agree = np.mean(got == oracle.linear_search_loop(
        left, right, smooth_factor=0.9, search_range=search_range))
    assert agree > 0.97, f"{agree:.3%}"       # the JAX test's bound
    assert (got[:, :2] == 0).all()


def test_linear_search_grayscale_and_fixed_sweeps_equal_jax(rng):
    left = rng.integers(5, 250, (16, 30)).astype(np.uint8)
    right = np.roll(left, -2, axis=1)
    want = np.asarray(jls.linear_search(jnp.asarray(left), jnp.asarray(right),
                                        search_range=6, iters=2))
    got = tls.linear_search(_t(left), _t(right), search_range=6, iters=2).numpy()
    np.testing.assert_array_equal(got, want)
