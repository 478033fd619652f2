"""``python -m stereo_reconstruction_tpu_torch`` against the JAX package's CLI.

The trees are MiddEval3-shaped directories the test writes
(``chip_smoke.write_middeval_scene``):

* the flat-row pair (64x96, the right view shifted by 5, GT 5 everywhere),
  whose pose fails in both packages, so no RANSAC draw is taken: ``run``
  (through ``python -m``) and ``run --batch`` give the same disparity and
  metrics as JAX's CLI (metrics within 1e-4);
* a 240x320 non-planar scene (``chip_smoke.nonplanar_scene``, seed 5),
  posed with the port's default draws, which JAX cannot reproduce: ``run``
  stages the disparity of the port's own ``run_pair`` on the loaded pair,
  bit for bit;
* ``eval`` and ``reconstruct`` (a HitNet results tree, with and without the
  GT-mean rescale) equal JAX's (metrics within 1e-4; the same mesh face
  count and valid-depth share);
* ``run --matcher sad | ncc`` on the flat-row pair equals JAX's CLI and the
  port's in-process ``run_pair``;
* ``rectify`` on a MiddEval3 tree of ``tests/test_uncalibrated.py::_pair``
  gives the in-process ``run_uncalibrated``'s F and inliers and writes the
  three PNGs;
* ``run --matcher perceptual --weights <narrow .npz>`` on the flat-row pair
  stages its outputs and agrees with JAX's CLI (100% within 2 px, >= 98%
  exact);
* ``bench`` raises ``NotImplementedError`` naming what brings it, and the
  default ``--device cuda`` raises without a card.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu import cli as jcli
from stereo_reconstruction_tpu_torch import cli as tcli
from stereo_reconstruction_tpu_torch import pipeline as tpipe
from stereo_reconstruction_tpu_torch.config import MatcherConfig, PipelineConfig
from stereo_reconstruction_tpu_torch.data import MiddEval3
from stereo_reconstruction_tpu_torch.io.mesh_io import read_off
from stereo_reconstruction_tpu_torch.io.pfm import read_pfm, write_pfm
from stereo_reconstruction_tpu_torch.perceptual.vgg import save_params_npz

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, REPO)
from chip_smoke import (  # noqa: E402
    flat_pair,
    narrow_vgg_params,
    nonplanar_disparity,
    nonplanar_scene,
    write_middeval_scene,
    write_png,
)

torch.set_num_threads(1)

TOL = 1e-4


def _lines(text):
    return [json.loads(x) for x in text.strip().splitlines() if x.startswith("{")]


def _close(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            continue
        if isinstance(v, str):
            assert got[k] == v, k
            continue
        assert abs(got[k] - v) <= TOL * max(1.0, abs(v)), k


@pytest.fixture(scope="module")
def flat_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("flat") / "MiddEval3")
    left, right = flat_pair()
    K = np.array([[96.0, 0, 48], [0, 96, 32], [0, 0, 1]])
    gt = np.full((64, 96), 5.0, np.float32)
    mask = np.full((64, 96), 255, np.uint8)
    write_middeval_scene(root, "Flat", left, right, K, ndisp=16, gt=gt, mask=mask,
                         gt_left=gt, mask_left=mask)
    return root


def _jax_cli(argv, capsys):
    capsys.readouterr()
    jcli.main(argv)
    return _lines(capsys.readouterr().out)


def _port_cli(argv, capsys):
    capsys.readouterr()
    tcli.main(argv + ["--device", "cpu"])
    return _lines(capsys.readouterr().out)


def test_run_on_the_flat_pair_equals_jax(flat_tree, tmp_path, capsys):
    args = ["run", "--data", flat_tree, "--scenario", "0", "--max-disparity", "16"]
    want = _jax_cli(args + ["--out", str(tmp_path / "jax")], capsys)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "stereo_reconstruction_tpu_torch"] + args
        + ["--out", str(tmp_path / "torch"), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = _lines(out.stdout)
    assert len(got) == len(want) == 1 and got[0]["scenario"] == want[0]["scenario"] == "Flat"
    assert got[0]["metrics"]["pose_ok"] == 0.0
    _close(got[0]["metrics"], want[0]["metrics"])
    assert got[0]["timings"].keys() == want[0]["timings"].keys()
    disp = read_pfm(str(tmp_path / "torch" / "Flat_disp.pfm"))
    np.testing.assert_array_equal(disp, read_pfm(str(tmp_path / "jax" / "Flat_disp.pfm")))
    assert np.mean(disp[:, :80] == 5) > 0.9


def test_run_batch_on_the_flat_pair_equals_jax(flat_tree, capsys):
    args = ["run", "--batch", "--data", flat_tree, "--scenario", "0", "0",
            "--max-disparity", "16"]
    want = _jax_cli(args, capsys)
    got = _port_cli(args, capsys)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["scenario"] == w["scenario"] == "Flat" and g["pose_ok"] == 0.0
        _close(g, w)
        assert g["timings"].keys() == w["timings"].keys()


def test_run_on_a_posed_scene_equals_run_pair(tmp_path, capsys):
    left, right, K, _, _, F, src = nonplanar_scene(np.random.default_rng(5), 240, 320)
    gt, mask = nonplanar_disparity(src, F)
    root = str(tmp_path / "MiddEval3")
    write_middeval_scene(root, "Posed", left, right, K, ndisp=80, gt=gt, mask=mask)
    got = _port_cli(["run", "--data", root, "--scenario", "0", "--max-disparity", "80",
                     "--out", str(tmp_path / "out"), "--mesh"], capsys)
    pair = MiddEval3(root).load_training(0)
    want = tpipe.run_pair(pair, PipelineConfig(matcher=MatcherConfig(max_disparity=80)),
                          device="cpu")
    assert got[0]["metrics"] == want.metrics and want.metrics["pose_ok"] == 1.0
    np.testing.assert_array_equal(read_pfm(str(tmp_path / "out" / "Posed_disp.pfm")),
                                  want.disparity)
    assert len(read_off(str(tmp_path / "out" / "Posed_mesh.off"))[2]) > 0


def test_eval_equals_jax(tmp_path, rng, capsys):
    disp = rng.uniform(-2, 70, (31, 47)).astype(np.float32)
    disp[rng.uniform(size=disp.shape) < 0.1] = 0
    gt = (disp + rng.normal(0, 3, disp.shape)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.1] = np.inf
    mask = np.where(rng.uniform(size=gt.shape) < 0.7, 255, 128).astype(np.uint8)
    paths = [str(tmp_path / n) for n in ("d.pfm", "gt.pfm", "m.png")]
    write_pfm(paths[0], disp)
    write_pfm(paths[1], gt)
    write_png(paths[2], mask)
    for extra in ([], ["--bad-thresh", "1.0", "--max-disp", "40"]):
        args = ["eval", "--disp", paths[0], "--gt", paths[1], "--mask", paths[2]] + extra
        want, got = _jax_cli(args, capsys), _port_cli(args, capsys)
        _close(got[0], want[0])
        assert got[0]["n_evaluated"] == want[0]["n_evaluated"] > 0


@pytest.mark.parametrize("rescale", [True, False])
def test_reconstruct_equals_jax(flat_tree, tmp_path, capsys, rescale):
    results = tmp_path / "HitNet"
    d = results / "trainingH" / "Flat"
    os.makedirs(d)
    img = np.full((64, 96), 9, np.uint8)
    img[10:30, 20:60] = 4
    write_png(str(d / "im0_reference.png"), np.repeat(img[..., None], 3, axis=2))
    args = ["reconstruct", "--data", flat_tree, "--results", str(results),
            "--scenario", "0"] + ([] if rescale else ["--no-gt-rescale"])
    want = _jax_cli(args + ["--out", str(tmp_path / "j.off")], capsys)
    got = _port_cli(args + ["--out", str(tmp_path / "t.off")], capsys)
    assert got[0]["scenario"] == want[0]["scenario"] == "Flat"
    assert got[0]["depth_valid_frac"] == want[0]["depth_valid_frac"] > 0
    assert len(read_off(str(tmp_path / "t.off"))[2]) == len(
        read_off(str(tmp_path / "j.off"))[2]) > 0


@pytest.mark.parametrize("argv,what", [
    (["bench", "--quick"], "benchmark"),
])
def test_unported_subcommands_raise(argv, what):
    with pytest.raises(NotImplementedError, match=what):
        tcli.main(argv)


def test_unported_matcher_raises(flat_tree, tmp_path, capsys):
    """The perceptual matcher, refused until it was ported, now runs: ``run
    --matcher perceptual --weights <narrow .npz>`` on the flat-row pair
    (pose fails, so the raw pair is matched) stages its outputs, and its
    disparity agrees with JAX's CLI on the same weights: 100% within 2 px
    and >= 98% exact (tests/test_torch_perceptual.py's gate)."""
    weights = str(tmp_path / "narrow.npz")
    save_params_npz(weights, narrow_vgg_params())
    args = ["run", "--data", flat_tree, "--scenario", "0", "--matcher", "perceptual",
            "--weights", weights, "--max-disparity", "16"]
    want = _jax_cli(args + ["--out", str(tmp_path / "jax")], capsys)
    got = _port_cli(args + ["--out", str(tmp_path / "torch")], capsys)
    assert len(got) == len(want) == 1 and got[0]["metrics"]["pose_ok"] == 0.0
    disp = read_pfm(str(tmp_path / "torch" / "Flat_disp.pfm"))
    jdisp = read_pfm(str(tmp_path / "jax" / "Flat_disp.pfm"))
    assert disp.shape == (64, 96) and os.path.isfile(str(tmp_path / "torch" / "Flat_pose.json"))
    assert np.mean(np.abs(disp - jdisp) <= 2) == 1.0 and np.mean(disp == jdisp) >= 0.98
    assert set(got[0]["metrics"]) == set(want[0]["metrics"])


@pytest.mark.parametrize("matcher", ["sad", "ncc"])
def test_run_with_a_dense_variant_equals_jax_and_run_pair(flat_tree, tmp_path, capsys,
                                                          matcher):
    args = ["run", "--data", flat_tree, "--scenario", "0", "--max-disparity", "16",
            "--matcher", matcher]
    want = _jax_cli(args + ["--out", str(tmp_path / "jax")], capsys)
    got = _port_cli(args + ["--out", str(tmp_path / "torch")], capsys)
    _close(got[0]["metrics"], want[0]["metrics"])
    disp = read_pfm(str(tmp_path / "torch" / "Flat_disp.pfm"))
    np.testing.assert_array_equal(disp, read_pfm(str(tmp_path / "jax" / "Flat_disp.pfm")))
    config = PipelineConfig(matcher=MatcherConfig(max_disparity=16, cost=matcher))
    res = tpipe.run_pair(MiddEval3(flat_tree).load_training(0), config, device="cpu")
    np.testing.assert_array_equal(disp, res.disparity)
    assert np.mean(disp[:, :80] == 5) > 0.9


def test_rectify_equals_run_uncalibrated(tmp_path, capsys):
    from stereo_reconstruction_tpu_torch.pipeline_uncalibrated import run_uncalibrated

    from test_uncalibrated import _pair

    left, right = (np.repeat(np.round(x)[..., None], 3, axis=2).astype(np.uint8)
                   for x in _pair())
    K = np.array([[184.0, 0, 92], [0, 184, 64], [0, 0, 1]])
    root = str(tmp_path / "MiddEval3")
    write_middeval_scene(root, "Shifted", left, right, K, ndisp=16)
    out = str(tmp_path / "rect")
    got = _port_cli(["rectify", "--data", root, "--scenario", "0", "--max-disparity", "16",
                     "--out", out], capsys)
    pair = MiddEval3(root).load_training(0)
    want = run_uncalibrated(pair.image_left, pair.image_right,
                            PipelineConfig(matcher=MatcherConfig(max_disparity=16)),
                            device="cpu")
    assert len(got) == 1 and got[0]["scenario"] == "Shifted"
    assert got[0]["num_inliers"] == want.num_inliers >= 50
    np.testing.assert_array_equal(np.asarray(got[0]["F"]), want.F)
    np.testing.assert_array_equal(np.asarray(got[0]["F_rectified"]), want.F_rectified)
    for name in ("rectified_left.png", "rectified_right.png", "disparity_linear.png"):
        assert os.path.exists(os.path.join(out, name))


def test_device_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    path = str(tmp_path / "d.pfm")
    write_pfm(path, np.zeros((4, 5), np.float32))
    write_png(str(tmp_path / "m.png"), np.zeros((4, 5), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["eval", "--disp", path, "--gt", path, "--mask", str(tmp_path / "m.png")])
