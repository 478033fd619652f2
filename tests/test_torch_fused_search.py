"""K3's plain twin (the port's fused block search) against the JAX
package's Pallas block search, run in interpret mode on the CPU, and
against the NumPy loop oracle.

The same numpy inputs go to ``pallas_block_search_right(...,
interpret=True)`` and to the port's wrapper
``cuda_block_search.block_search_fused``, which takes the plain twin for
CPU tensors. On the integer-valued ``_random_stereo`` images every window
sum is exact, so the disparities must agree bit for bit across tiles,
sweeps and smoothing modes, at tiles narrower than the sweep count (where
a tile's boundary depends on the one before it) and at ``smooth_factor``
0, where ``+inf * 0`` is NaN and ``jnp.min`` and ``torch.min`` let it win:
the column takes its sentinel ``-x``. These pin the semantics that K3
itself is held to on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu import oracle
from stereo_reconstruction_tpu.config import MatcherConfig as JaxMatcherConfig
from stereo_reconstruction_tpu.ops.pallas_block_search import pallas_block_search_right
from stereo_reconstruction_tpu_torch.config import MatcherConfig
from stereo_reconstruction_tpu_torch.ops import cuda_block_search as cbs

from test_block_search import _random_stereo

torch.set_num_threads(1)

# (h, w, extra left columns, min_d, max_d, block, tile_width, iters, mode)
CASES = [
    (28, 40, 0, 0, 10, 7, 128, 2, "reference"),     # 1 tile
    (20, 80, 0, 0, 8, 5, 40, 2, "reference"),       # 2 tiles
    (20, 90, 0, 0, 8, 5, 64, 2, "reference"),       # W not a multiple of TW
    (20, 90, 0, 0, 8, 5, 64, 1, "reference"),       # sweep 0 only
    (20, 90, 0, 0, 8, 5, 64, 3, "reference"),
    (20, 90, 0, 0, 8, 5, 64, 2, "intended"),
    (20, 90, 0, 0, 8, 5, 64, 3, "none"),
    (21, 40, 9, 2, 12, 5, 128, 2, "reference"),     # min_d 2, wider left
    # tiles narrower than row_smooth_iters: each boundary chains to the last
    (20, 90, 0, 0, 8, 5, 2, 3, "intended"),
    (20, 90, 0, 0, 8, 5, 3, 3, "reference"),
]


def _pair(rng, h, w, extra, max_d=8):
    left, right = _random_stereo(rng, h=h, w=w, max_d=max_d)
    return np.pad(left, ((0, 0), (0, extra), (0, 0))), right


@pytest.mark.parametrize("h,w,extra,min_d,max_d,bs,tw,iters,mode", CASES)
def test_twin_bit_equal_to_jax_pallas_search(rng, h, w, extra, min_d, max_d, bs,
                                             tw, iters, mode):
    left, right = _pair(rng, h, w, extra)
    kw = dict(block_size=bs, min_disparity=min_d, max_disparity=max_d,
              smooth_factor=0.9, row_smooth_iters=iters)
    want = np.asarray(pallas_block_search_right(
        jnp.asarray(left), jnp.asarray(right), JaxMatcherConfig(**kw),
        tile_width=tw, interpret=True, smooth_mode=mode))
    got = cbs.block_search_fused(torch.from_numpy(left), torch.from_numpy(right),
                                 MatcherConfig(**kw), tile_width=tw,
                                 smooth_mode=mode).numpy()
    assert got.dtype == np.float32 and got.shape == (h, w)
    # tolerance: none — exact window sums, the same recurrence
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,mode", [(0, "intended"), (1, "intended"), (2, "intended"),
                                       (0, "reference"), (1, "reference")])
def test_twin_bit_equal_to_jax_at_zero_smooth_factor(seed, mode):
    """smooth_factor 0: a discounted +inf cost is NaN, and a NaN wins the
    minimum in both versions, so its column takes the sentinel -x."""
    left, right = _random_stereo(np.random.default_rng(seed), h=20, w=40, max_d=8)
    kw = dict(block_size=5, min_disparity=0, max_disparity=30, smooth_factor=0.0,
              row_smooth_iters=2)
    want = np.asarray(pallas_block_search_right(
        jnp.asarray(left), jnp.asarray(right), JaxMatcherConfig(**kw), tile_width=64,
        interpret=True, smooth_mode=mode))
    got = cbs.block_search_fused(torch.from_numpy(left), torch.from_numpy(right),
                                 MatcherConfig(**kw), tile_width=64,
                                 smooth_mode=mode).numpy()
    # tolerance: none — exact window sums, the same recurrence
    np.testing.assert_array_equal(got, want)
    if mode == "intended":
        # column 37 has one finite plane (d = 0); a discount of any other
        # plane makes a NaN, and the NaN rule decides every row there
        assert (want[:, 37] == -37).all()


@pytest.mark.parametrize("h,w,max_d_img,max_d,bs,tw,bound", [
    (28, 40, 8, 10, 7, 128, 0.99),    # one tile
    (20, 80, 6, 8, 5, 40, 0.98),      # two tiles
])
def test_twin_matches_loop_oracle(rng, h, w, max_d_img, max_d, bs, tw, bound):
    """The JAX package's own bounds (tests/test_pallas_kernel.py)."""
    left, right = _random_stereo(rng, h=h, w=w, max_d=max_d_img)
    want = oracle.block_search_right_loop(left, right, block_size=bs,
                                          min_disparity=0, max_disparity=max_d,
                                          smooth_factor=0.9)
    got = cbs.block_search_fused(
        torch.from_numpy(left), torch.from_numpy(right),
        MatcherConfig(block_size=bs, max_disparity=max_d, row_smooth_iters=2),
        tile_width=tw).numpy()
    agree = np.mean(got == want)
    assert agree > bound, f"only {agree:.3%} agreement with the loop oracle"


def test_tile_width_follows_the_tpu_kernel():
    assert cbs.tile_width_for(1408, 512) == 512
    assert cbs.tile_width_for(40, 512) == 128
    assert cbs.tile_width_for(90, 64) == 64


def test_wrapper_takes_twin_on_cpu_and_counts_no_launch(rng):
    left, right = _pair(rng, 20, 90, 0)
    cfg = MatcherConfig(block_size=5, max_disparity=8)
    L, R = torch.from_numpy(left), torch.from_numpy(right)
    got = cbs.block_search_fused(L, R, cfg, tile_width=64)
    want = cbs.block_search_fused_plain(L, R, cfg, tile_width=64)
    assert cbs.LAUNCHES == 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("kw,match", [
    (dict(min_disparity=-2, max_disparity=6), "min_disparity"),
    (dict(block_size=1), "block_size"),
    (dict(smooth_mode="sideways"), "smooth_mode"),
])
def test_wrapper_rejects(rng, kw, match):
    left, right = _pair(rng, 12, 16, 0)
    mode = kw.pop("smooth_mode", "reference")
    cfg = MatcherConfig(**{"block_size": 5, "max_disparity": 6, **kw})
    with pytest.raises(ValueError, match=match):
        cbs.block_search_fused(torch.from_numpy(left), torch.from_numpy(right), cfg,
                               smooth_mode=mode)
