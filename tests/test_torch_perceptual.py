"""The perceptual (VGG-16 / LPIPS) matcher of the port against the JAX
package, on the CPU.

Inputs come from numpy seeds and go through both packages. The tower runs
at full VGG-16 widths only for single images (``vgg16_features``,
``lpips_cost_volume``); the windowed search, the notebook oracle and the
pipeline use narrow weights in the JAX layout (widths 4, 8, 8, 8, 8 with
their own ``lins``), since every per-window forward at full width takes
tens of seconds in JAX on a CPU. Tolerances:

* ``init_vgg16_params``, the ``.npz`` layout and ``convert_torch_lpips``:
  equal arrays;
* VGG stages: within 1e-4 of each stage's largest |value| (the convolution
  sums run in other orders);
* cost volumes: +inf in the same places, finite entries within 1e-6
  (full image, entries ~0.03) and 2e-4 (windowed, entries ~0.3), absolute;
* the smoothers: bit-equal to JAX given JAX's own weight table (the
  expression of ``perceptual/cost.py:313-314`` evaluated at prev = 0),
  which the port's table matches within 2 ulp; with the port's own table
  >= 99.9% equal;
* whole searches: 100% of pixels within 2 px and >= 98% exact, the JAX
  package's gate against the notebook (``tests/test_perceptual.py``).

JAX's windowed volume clamps the last row block's start when ``row_block``
does not divide H, which moves that block's rows (the bottom-edge caveat
of the reference); the port takes each row's own crops, so it is compared
with JAX at ``row_block`` 1, and one test records the shift.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu import pipeline as jpipe
from stereo_reconstruction_tpu.config import PerceptualConfig as JaxPerceptualConfig
from stereo_reconstruction_tpu.config import PipelineConfig as JaxPipelineConfig
from stereo_reconstruction_tpu.data.records import StereoPair as JaxStereoPair
from stereo_reconstruction_tpu.perceptual import cost as jcost
from stereo_reconstruction_tpu.perceptual import notebook_oracle as jnb
from stereo_reconstruction_tpu.perceptual import vgg as jvgg
from stereo_reconstruction_tpu_torch import pipeline as tpipe
from stereo_reconstruction_tpu_torch.config import PerceptualConfig, from_jax_config
from stereo_reconstruction_tpu_torch.data.records import StereoPair
from stereo_reconstruction_tpu_torch.perceptual import cost as tcost
from stereo_reconstruction_tpu_torch.perceptual import notebook_oracle as tnb
from stereo_reconstruction_tpu_torch.perceptual import scan
from stereo_reconstruction_tpu_torch.perceptual import vgg as tvgg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))
from chip_smoke import narrow_vgg_params, perceptual_pair, perceptual_volume  # noqa: E402
from test_torch_pipeline import _scene  # noqa: E402

torch.set_num_threads(1)

NARROW = (4, 8, 8, 8, 8)
STAGE_RTOL = 1e-4
FULL_IMAGE_ATOL = 1e-6
WINDOWED_ATOL = 2e-4


def jax_table(D, sigma=25.0, bias=0.85):
    """JAX's own weights (``perceptual/cost.py:313-314`` at prev = 0) for
    distances 0..D."""
    f = jax.jit(lambda dv, prev: (1.0 - jnp.exp(-jnp.abs(dv[:, None] - prev[None, :])
                                                / sigma)) + bias)
    return np.asarray(f(jnp.arange(D + 1, dtype=jnp.float32), jnp.zeros((1,), jnp.float32)))[:, 0]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _agreement(got, want):
    return float(np.mean(got == want)), float(np.mean(np.abs(got - want) <= 2.0))


@pytest.fixture(scope="module")
def full_params():
    return jvgg.init_vgg16_params(0)


@pytest.fixture(scope="module")
def windowed_case():
    """10x44, D=12: the narrow tower's windowed volume and search in JAX
    (row_block 1, where it takes every row's own crops)."""
    rng = np.random.default_rng(7)
    left, right = perceptual_pair(rng, 10, 44)
    params = narrow_vgg_params()
    jcfg = JaxPerceptualConfig(max_disparity=12, row_block=1)
    vol = np.asarray(jcost.windowed_lpips_cost_volume(params, jnp.asarray(left),
                                                      jnp.asarray(right), jcfg))
    disp = np.asarray(jcost.windowed_smooth_argmin(jnp.asarray(vol), jcfg))
    return params, left, right, vol, disp


# ---- vgg.py ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_init_vgg16_params_equal_jax(seed):
    want, got = jvgg.init_vgg16_params(seed), tvgg.init_vgg16_params(seed)
    for jb, tb in zip(want["convs"], got["convs"], strict=True):
        for (jw, jb_), (tw, tb_) in zip(jb, tb, strict=True):
            assert tw.dtype == np.float32 and np.array_equal(tw, jw) and np.array_equal(tb_, jb_)
    for jl, tl in zip(want["lins"], got["lins"], strict=True):
        np.testing.assert_array_equal(tl, jl)


def test_params_npz_round_trip_crosses_packages(full_params, tmp_path):
    port_path, jax_path = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tvgg.save_params_npz(port_path, full_params)
    jvgg.save_params_npz(jax_path, full_params)
    for loaded in (jvgg.load_params_npz(port_path), tvgg.load_params_npz(jax_path)):
        for jb, tb in zip(full_params["convs"], loaded["convs"], strict=True):
            for (w0, b0), (w1, b1) in zip(jb, tb, strict=True):
                np.testing.assert_array_equal(w1, w0)
                np.testing.assert_array_equal(b1, b0)
        for l0, l1 in zip(full_params["lins"], loaded["lins"], strict=True):
            np.testing.assert_array_equal(l1, l0)
    assert tvgg.get_params(port_path) is tvgg.get_params(port_path)


@pytest.mark.parametrize("layout", ["slice", "features"])
def test_convert_torch_lpips_equals_jax(layout):
    rng = np.random.default_rng(2)
    conv_idx = [(0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28)]
    state, in_ch = {}, 3
    for bi, idxs in enumerate(conv_idx):
        for idx in idxs:
            ch = NARROW[bi]
            key = f"net.slice{bi + 1}.{idx}" if layout == "slice" else f"net.features.{idx}"
            state[key + ".weight"] = rng.normal(size=(ch, in_ch, 3, 3)).astype(np.float32)
            state[key + ".bias"] = rng.normal(size=ch).astype(np.float32)
            in_ch = ch
    for li, ch in enumerate(NARROW):
        state[f"lins.{li}.model.1.weight"] = rng.uniform(size=(1, ch, 1, 1)).astype(np.float32)
    want, got = jvgg.convert_torch_lpips(state), tvgg.convert_torch_lpips(state)
    for jb, tb in zip(want["convs"], got["convs"], strict=True):
        for (w0, b0), (w1, b1) in zip(jb, tb, strict=True):
            np.testing.assert_array_equal(w1, w0)
            np.testing.assert_array_equal(b1, b0)
    for l0, l1 in zip(want["lins"], got["lins"], strict=True):
        np.testing.assert_array_equal(l1, l0)


def test_vgg16_features_full_width_equal_jax(full_params):
    img = np.random.default_rng(1).integers(0, 255, (32, 48, 3)).astype(np.float32)
    want = jvgg.vgg16_features(full_params, jnp.asarray(img))
    got = tvgg.vgg16_features(full_params, _t(img))
    for s, (w, g, ch, stride) in enumerate(zip(want, got, tvgg.STAGE_CHANNELS,
                                               tvgg.STAGE_STRIDES)):
        w = np.asarray(w)
        assert g.shape == w.shape == (ch, 32 // stride, 48 // stride)
        assert np.abs(g.numpy() - w).max() <= STAGE_RTOL * np.abs(w).max(), f"stage {s}"


def test_batched_features_equal_jax_at_narrow_widths():
    params = narrow_vgg_params()
    wins = np.random.default_rng(4).integers(0, 255, (6, 17, 17, 3)).astype(np.float32)
    want = jvgg.vgg16_features_batched(params, jnp.asarray(wins))
    got = tvgg.vgg16_features_batched(params, _t(wins))
    assert [tuple(g.shape) for g in got] == [(6, c, s, s) for c, s in
                                             zip(NARROW, (17, 8, 4, 2, 1))]
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= STAGE_RTOL * np.abs(w).max()


def test_vgg_module_is_cached_per_weights_seed_and_device(full_params, tmp_path):
    path = str(tmp_path / "narrow.npz")
    tvgg.save_params_npz(path, narrow_vgg_params())
    m = tvgg.vgg_module(path, seed=0, device="cpu")
    assert m is tvgg.vgg_module(path, seed=0, device="cpu")
    assert [c.out_channels for c in m.blocks[0]] == [4, 4] and len(m.lins) == 5
    he = tvgg.vgg_module("", seed=0, device="cpu")
    assert he is not m and he is not tvgg.vgg_module("", seed=1, device="cpu")
    # a JAX-made dict (jnp arrays) loads into the same module
    jax_made = jax.tree_util.tree_map(jnp.asarray, full_params)
    loaded = tvgg.VGG16Features.from_params(jax_made)
    for a, b in zip(loaded.parameters(), he.parameters(), strict=True):
        assert torch.equal(a, b)
    assert tvgg.as_module(he, "cpu") is he
    with pytest.raises(ValueError, match="VGG module is on cpu"):
        tvgg.as_module(he, "meta")


def test_vgg_module_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvgg.vgg_module()


def test_normalize_features_equal_jax():
    feat = np.random.default_rng(0).normal(size=(8, 5, 7)).astype(np.float32)
    feat[:, 0, 0] = 0.0                       # a zero column: eps outside the sqrt
    want = np.asarray(jvgg.normalize_features(jnp.asarray(feat)))
    got = tvgg.normalize_features(_t(feat)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    assert np.all(got[:, 0, 0] == 0)


# ---- cost.py: full image ----------------------------------------------------


@pytest.mark.parametrize("window", [5, 17])
def test_lpips_cost_volume_equals_jax(full_params, window):
    """Window 17 takes box widths 17, 8, 4, 2, 1: the even ones pad
    asymmetrically."""
    rng = np.random.default_rng(11)
    left = rng.integers(0, 255, (32, 48, 3)).astype(np.float32)
    right = rng.integers(0, 255, (32, 48, 3)).astype(np.float32)
    want = np.asarray(jcost.lpips_cost_volume(full_params, jnp.asarray(left),
                                              jnp.asarray(right),
                                              JaxPerceptualConfig(max_disparity=8,
                                                                  window_size=window)))
    got = tcost.lpips_cost_volume(full_params, _t(left), _t(right),
                                  PerceptualConfig(max_disparity=8, window_size=window)).numpy()
    assert got.shape == want.shape == (8, 32, 48)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert np.abs(got[fin] - want[fin]).max() <= FULL_IMAGE_ATOL


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_perceptual_smooth_argmin_equals_jax(iters):
    rng = np.random.default_rng(20 + iters)
    vol = perceptual_volume(rng, 9, 12, 40, ties=iters == 3).transpose(1, 0, 2).copy()
    cfg = JaxPerceptualConfig(max_disparity=12)
    want = np.asarray(jcost.perceptual_smooth_argmin(jnp.asarray(vol), cfg, iters=iters))
    with_jax_table = tcost.perceptual_smooth_argmin(
        _t(vol), PerceptualConfig(max_disparity=12), iters=iters,
        table=_t(jax_table(12))).numpy()
    np.testing.assert_array_equal(with_jax_table, want)
    own = tcost.perceptual_smooth_argmin(_t(vol), PerceptualConfig(max_disparity=12),
                                         iters=iters).numpy()
    assert np.mean(own == want) >= 0.999


def test_perceptual_smooth_argmin_on_jax_lpips_volume(full_params):
    """Both smoothers of the full-image path on the volume JAX's
    lpips_cost_volume makes (window 17): bit-equal given JAX's table."""
    rng = np.random.default_rng(12)
    left, right = perceptual_pair(rng, 32, 48, shift=3)
    cfg = JaxPerceptualConfig(max_disparity=8)
    vol = np.asarray(jcost.lpips_cost_volume(full_params, jnp.asarray(left),
                                             jnp.asarray(right), cfg))
    want = np.asarray(jcost.perceptual_smooth_argmin(jnp.asarray(vol), cfg))
    got = tcost.perceptual_smooth_argmin(_t(vol), PerceptualConfig(max_disparity=8),
                                         table=_t(jax_table(8))).numpy()
    np.testing.assert_array_equal(got, want)


def test_hand_worked_smoothing_case():
    """tests/test_perceptual.py's row: x=0 picks d=2 outright; at x=1 the
    near tie (2.0 at d=1 against 2.05 at d=2) goes to d=2 under the weight
    around the left neighbour's 2, in both smoothers."""
    cost = np.full((4, 1, 3), 10.0, np.float32)
    cost[:, 0, 0] = [10.0, 10.0, 1.0, 10.0]
    cost[:, 0, 1] = [10.0, 2.0, 2.05, 10.0]
    w1, w2 = (1 - np.exp(-1 / 25.0)) + 0.85, (1 - np.exp(0)) + 0.85
    assert w2 * 2.05 < w1 * 2.0
    cfg = PerceptualConfig(max_disparity=4)
    full = tcost.perceptual_smooth_argmin(_t(cost), cfg, iters=2).numpy()
    windowed = tcost.windowed_smooth_argmin(_t(cost.transpose(1, 0, 2)), cfg).numpy()
    want = np.asarray(jcost.windowed_smooth_argmin(
        jnp.asarray(cost.transpose(1, 0, 2)), JaxPerceptualConfig(max_disparity=4)))
    assert full[0, 0] == full[0, 1] == 2
    assert windowed[0, 0] == windowed[0, 1] == 2
    np.testing.assert_array_equal(windowed, want)


# ---- cost.py: windowed ------------------------------------------------------


@pytest.mark.parametrize("row_block", [1, 3, 8])
def test_windowed_cost_volume_equals_jax(windowed_case, row_block):
    """Window 17, 10x44, D=12: the port at any row_block against JAX at
    row_block 1 (results are row-identical for any row_block)."""
    params, left, right, want, _ = windowed_case
    got = tcost.windowed_lpips_cost_volume(
        params, _t(left), _t(right),
        PerceptualConfig(max_disparity=12, row_block=row_block)).numpy()
    assert got.shape == want.shape == (10, 12, 44)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert np.abs(got[fin] - want[fin]).max() <= WINDOWED_ATOL


def test_jax_row_block_clamp_moves_the_last_block(windowed_case):
    """The reference's fault, recorded: at row_block 3 on 10 rows JAX's last
    block starts at row 9, dynamic_slice clamps it to 7, so JAX's row 9 holds
    row 7's crops; at row_block 5 (dividing 10) nothing moves. The port's
    volume is row-identical for any row_block."""
    params, left, right, want, _ = windowed_case

    def jax_volume(rb):
        return np.asarray(jcost.windowed_lpips_cost_volume(
            params, jnp.asarray(left), jnp.asarray(right),
            JaxPerceptualConfig(max_disparity=12, row_block=rb)))

    fin = np.isfinite(want[0])                # the same candidates in every row

    def err(a, b):
        return np.abs(a[..., fin] - b[..., fin]).max()

    clamped, divides = jax_volume(3), jax_volume(5)
    assert err(clamped[9], want[7]) <= WINDOWED_ATOL
    assert err(clamped[9], want[9]) > 100 * WINDOWED_ATOL
    assert err(divides, want) <= WINDOWED_ATOL
    port = tcost.windowed_lpips_cost_volume(params, _t(left), _t(right),
                                            PerceptualConfig(max_disparity=12, row_block=3))
    assert err(port.numpy(), want) <= WINDOWED_ATOL


@pytest.mark.parametrize("D", [12, 100, 400])
def test_weight_table_within_2_ulp_of_jax(D):
    got = scan.weight_table(D, 25.0, 0.85).numpy()
    want = jax_table(D)
    assert got.dtype == np.float32 and got.shape == (D + 1,)
    assert np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64)).max() <= 2


@pytest.mark.parametrize("chunk", [20, 5, 1])
def test_windowed_smoother_bit_equal_to_jax_with_its_table(windowed_case, chunk):
    _, _, _, vol, _ = windowed_case
    jcfg = JaxPerceptualConfig(max_disparity=12, chunk=chunk)
    want = np.asarray(jcost.windowed_smooth_argmin(jnp.asarray(vol), jcfg))
    got = tcost.windowed_smooth_argmin(_t(vol), PerceptualConfig(max_disparity=12, chunk=chunk),
                                       table=_t(jax_table(12))).numpy()
    np.testing.assert_array_equal(got, want)


def test_windowed_smoother_with_its_own_table(windowed_case):
    _, _, _, vol, want = windowed_case
    got = tcost.windowed_smooth_argmin(_t(vol), PerceptualConfig(max_disparity=12)).numpy()
    assert np.mean(got == want) >= 0.999


# (h, d, w, chunk, ties): the planted cases of chip_smoke's [perceptual]
# phase: ties, W not a multiple of chunk, W = 1, chunk 1 and 20, the clamp
# mean == size near the right edge, chunk wider than W; then "specials"
# (NaN, +0.0 and -0.0 seeded: K4's order key), H = 1 and H < len, D = 33
# and 200, chunk 1, chunks 33 and 64 (a warp of K4 owns several
# positions), W = chunk + 1
PLANTED = [(6, 12, 50, 20, False), (5, 12, 50, 20, True), (4, 7, 1, 20, False),
           (5, 8, 33, 1, True), (4, 40, 45, 20, False), (3, 30, 70, 7, True),
           (3, 12, 40, 64, False),
           (5, 12, 50, 20, "specials"), (3, 40, 130, 64, "specials"), (1, 12, 50, 20, False),
           (3, 12, 60, 20, True), (4, 33, 50, 20, False), (2, 200, 230, 20, False),
           (3, 12, 20, 1, "specials"), (4, 12, 70, 33, True), (4, 12, 21, 20, False)]


@pytest.mark.parametrize("h,d,w,chunk,ties", PLANTED)
def test_windowed_smoother_on_planted_volumes(h, d, w, chunk, ties):
    vol = perceptual_volume(np.random.default_rng(w + chunk), h, d, w, ties=ties is True,
                            specials=ties == "specials")
    want = np.asarray(jcost.windowed_smooth_argmin(
        jnp.asarray(vol), JaxPerceptualConfig(max_disparity=d, chunk=chunk)))
    launches = scan.LAUNCHES
    got = scan.window_scan(_t(vol), _t(jax_table(d)), chunk).numpy()
    assert scan.LAUNCHES == launches               # the twin on the CPU, no launch
    np.testing.assert_array_equal(got, want)
    sizes = np.minimum(d, w - np.arange(w))
    clamps = (want[:, :-1] >= sizes[None, 1:]) & (np.arange(1, w) % chunk != 0)[None]
    if w > d and chunk > 1:
        assert clamps.any(), "the planted edge should reach the clamp"


def test_windowed_search_equals_jax(windowed_case):
    params, left, right, _, want = windowed_case
    got = tcost.windowed_lpips_search(params, _t(left), _t(right),
                                      PerceptualConfig(max_disparity=12)).numpy()
    exact, within2 = _agreement(got, want)
    assert within2 == 1.0 and exact >= 0.98, (exact, within2)


@pytest.mark.parametrize("mode", ["windowed", "full_image"])
def test_perceptual_window_search_dispatches_on_mode(mode):
    params = narrow_vgg_params()
    left, right = perceptual_pair(np.random.default_rng(9), 16, 40)
    cfg = dict(max_disparity=6, mode=mode, row_block=1)
    want = np.asarray(jcost.perceptual_window_search(params, jnp.asarray(left),
                                                     jnp.asarray(right),
                                                     JaxPerceptualConfig(**cfg)))
    got = tcost.perceptual_window_search(params, _t(left), _t(right),
                                         PerceptualConfig(**cfg)).numpy()
    assert got.shape == (16, 40) and got.min() >= 0 and got.max() < 6
    exact, within2 = _agreement(got, want)
    assert within2 == 1.0 and exact >= 0.98, (exact, within2)


# ---- notebook_oracle.py -----------------------------------------------------


@pytest.fixture(scope="module")
def oracle_case():
    left, right = perceptual_pair(np.random.default_rng(13), 6, 24)
    params = narrow_vgg_params()
    want = jnb.notebook_window_search(params, left, right, max_disparity=12)
    return params, left, right, want


def test_notebook_window_search_equals_jax(oracle_case):
    params, left, right, want = oracle_case
    got = tnb.notebook_window_search(params, left, right, max_disparity=12, device="cpu")
    exact, within2 = _agreement(got, want)
    assert within2 == 1.0 and exact >= 0.98, (exact, within2)
    half = tnb.notebook_window_search(params, left, right, max_disparity=12, n_rows=3,
                                      device="cpu")
    np.testing.assert_array_equal(half[:3], got[:3])
    assert not half[3:].any()


def test_notebook_rows_equals_jax(oracle_case):
    params, left, right, want = oracle_case
    rows = (0, 2, 5)
    jrows = jnb.notebook_rows(params, left, right, rows, want, max_disparity=12)
    trows = tnb.notebook_rows(params, left, right, rows, want, max_disparity=12,
                              device="cpu")
    assert sorted(trows) == list(rows)
    for y in rows:
        exact, within2 = _agreement(trows[y], jrows[y])
        assert within2 == 1.0 and exact >= 0.98, (y, exact, within2)


def test_windowed_search_tracks_the_port_oracle(oracle_case):
    """The port's windowed search against the port's own notebook oracle:
    fed the search's row y-1, each oracle row is the search's row y."""
    params, left, right, _ = oracle_case
    got = tcost.windowed_lpips_search(params, _t(left), _t(right),
                                      PerceptualConfig(max_disparity=12)).numpy()
    rows = tnb.notebook_rows(params, left, right, range(6), got, max_disparity=12,
                             device="cpu")
    oracle = np.stack([rows[y] for y in range(6)])
    exact, within2 = _agreement(got, oracle)
    assert within2 == 1.0 and exact >= 0.98, (exact, within2)


# ---- the pipeline -----------------------------------------------------------


@pytest.fixture(scope="module")
def narrow_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("weights") / "narrow.npz")
    tvgg.save_params_npz(path, narrow_vgg_params())
    return path


def _configs(npz, max_disparity=12):
    """The JAX config (row_block 1) and the port's (its default row_block)
    for the perceptual matcher with the narrow weights."""
    jcfg = JaxPipelineConfig()
    jcfg = jcfg.replace(
        matcher=dataclasses.replace(jcfg.matcher, cost="perceptual",
                                    max_disparity=max_disparity),
        perceptual=dataclasses.replace(jcfg.perceptual, weights_path=npz, row_block=1))
    tcfg = from_jax_config(jcfg)
    return jcfg, tcfg.replace(perceptual=dataclasses.replace(tcfg.perceptual, row_block=8))


def test_compute_disparity_perceptual_equals_jax(narrow_npz):
    jcfg, tcfg = _configs(narrow_npz)
    left, right = perceptual_pair(np.random.default_rng(17), 12, 40)
    want = np.asarray(jpipe.compute_disparity(jnp.asarray(left), jnp.asarray(right), jcfg))
    got = tpipe.compute_disparity(_t(left), _t(right), tcfg)
    assert got.device.type == "cpu" and got.shape == (12, 40)
    exact, within2 = _agreement(got.numpy(), want)
    assert within2 == 1.0 and exact >= 0.98, (exact, within2)


def test_run_pair_perceptual_equals_jax(narrow_npz, tmp_path):
    fields, F = _scene()
    jcfg, tcfg = _configs(narrow_npz, max_disparity=16)
    want = jpipe.run_pair(JaxStereoPair(**fields), jcfg, fixed_F=F,
                          output_dir=str(tmp_path / "jax"))
    got = tpipe.run_pair(StereoPair(**fields), tcfg, fixed_F=F,
                         output_dir=str(tmp_path / "torch"), device="cpu")
    assert got.disparity.shape == want.disparity.shape == (48, 64)
    exact, within2 = _agreement(got.disparity, want.disparity)
    assert within2 == 1.0 and exact >= 0.98, (exact, within2)
    assert os.path.isfile(str(tmp_path / "torch" / "scene_disp.pfm"))
    assert set(got.metrics) == set(want.metrics)
