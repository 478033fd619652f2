"""The bundle-adjustment kernel's own source, built for the host, against its
plain twin.

``csrc/ba.cuh`` (launched by ``ops/cuda_ba.py``) runs a CTA a problem and a
thread a point, its threads meeting at warp shuffles and ``__syncthreads``.
Here the same source is built with the host's C++ compiler against the
stand-ins of ``tests/ba_host/`` (a CTA's threads as fibers that meet at
every warp-wide operation and barrier; ``-ffp-contract=off``) and called
through ctypes on CPU tensors, through the same argument marshalling as the
card (``cuda_ba.call``).

The twin is ``pose/ba.py::bundle_adjust_plain`` with its rounding pinned to
the kernel's (``ba_twin.py``, which says why and holds the kernel to it bit
for bit, ``compare``).

Cases: the two benchmark fixtures (``data/posed_request_matches.npz``,
``data/far_winner_request.npz``) through ``refine_pose``'s point selection
from RANSAC's two starts, with the Huber and the L2 loss, and at 20, 60 and
128 points (one, two and four warps); a scene with fewer survivors than
points, so zero-weight padded points; a start several degrees off that
ends unconverged; no step at all; and a batch of two pairs, which must
equal each pair alone bit for bit. The pose layer's limits raise before
SIFT. Skips where no C++ compiler is found.
"""

import ctypes
import dataclasses
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu_torch import pipeline as pipeline_mod
from stereo_reconstruction_tpu_torch import pipeline_batch
from stereo_reconstruction_tpu_torch.config import BundleAdjustmentConfig, PipelineConfig
from stereo_reconstruction_tpu_torch.kernels import build, launch
from stereo_reconstruction_tpu_torch.ops import cuda_ba, cuda_ransac
from stereo_reconstruction_tpu_torch.pose import ba as pba
from stereo_reconstruction_tpu_torch.pose import pipeline as pose_pipeline
from stereo_reconstruction_tpu_torch.pose import ransac as pransac
from stereo_reconstruction_tpu_torch.pose.eight_point import eight_point

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "stereo_reconstruction_tpu_torch", "csrc")
sys.path.insert(0, os.path.join(HERE, ".."))
from chip_smoke import request_matches  # noqa: E402
from ba_twin import compare  # noqa: E402
from test_torch_ransac_host import K, scene_case, truth_angles  # noqa: E402

torch.set_num_threads(1)

Kt = torch.from_numpy(K)
# the 8 matches of the posed fixture whose eight-point solve is 2.9 / 20.8
# degrees off (tests/test_torch_ba_rounds.py): one round from there ends
# still descending
FAR_SAMPLE = [65, 147, 62, 78, 167, 32, 145, 49]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the BA kernel's source for the host")
    launcher = open(os.path.join(CSRC, "ba.cu")).read()
    launches = launcher.count("<<<")
    launcher, n = re.subn(r"([\w:]+)<<<(.*?), (.*?), .*?, .*?>>>\((.*?)\);",
                          r"host::launch(\2, \3, [&] { \1(\4); });", launcher, flags=re.S)
    assert n == launches == 1 and "<<<" not in launcher
    out = tmp_path_factory.mktemp("ba_host")
    shutil.copy(os.path.join(CSRC, "ba.cuh"), out / "ba.cuh")
    (out / "ba.cu").write_text(launcher)
    so = out / "libba_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-ffp-contract=off",
                    "-pthread", "-I", os.path.join(HERE, "ba_host"), "-x", "c++",
                    str(out / "ba.cu"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    launch.declare(lib)
    # the launcher's entry points call the host build for this module's tests
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "load_library", lambda: lib)
        yield lib


def run_kernel(kl, kr, Kl, Kr, w, R0, T0, X0, config):
    """The host-built kernel on B pairs from S starts each: the ``BAResult``
    fields with leading (B, S)."""
    b, _, n = kl.shape
    out = cuda_ba.result_buffers((b, R0.shape[1]), n, "cpu")
    cuda_ba.check(kl, kr, Kl, Kr, w, R0, T0, X0, config)
    rc = cuda_ba.call(*(t.contiguous() for t in (kl, kr, Kl, Kr, w, R0, T0, X0)), config,
                      pba.SETTLE_WINDOW, pba.SETTLE_RTOL, out, None)
    assert rc == 0, f"host launch refused: {rc}"
    return out


def selection(ml, mr, nv, config=PipelineConfig(), seed=0):
    """``refine_pose``'s BA problem of these matches: RANSAC's twin on draws
    of ``seed``, then ``select_points``."""
    u = pransac.draw_uniforms(config.ransac, ml.shape[-1], torch.Generator().manual_seed(seed))
    rr = pransac.ransac_plain(ml, mr, Kt, Kt, config.ransac, torch.tensor(nv), u)
    return pose_pipeline.select_points(ml, mr, Kt, Kt, rr, torch.tensor(nv), config)


def compare_selection(sel, config: BundleAdjustmentConfig):
    return compare(run_kernel, sel.keypoints_left, sel.keypoints_right, Kt, Kt, sel.weights,
                   sel.rotations, sel.translations, sel.points, config)


@pytest.mark.parametrize("loss", ["huber", "l2"])
@pytest.mark.parametrize("name", ["posed_request_matches", "far_winner_request"])
def test_kernel_source_equals_twin_on_the_fixtures(lib, name, loss):
    sel = selection(*request_matches(name, 500))
    got, _ = compare_selection(sel, BundleAdjustmentConfig(loss=loss))
    assert bool(got.converged.all()) and float(got.final_cost.max()) < 1.0
    assert int(sel.weights.sum()) == 60


@pytest.mark.parametrize("points", [20, 128])
def test_kernel_source_equals_twin_on_one_and_four_warps(lib, points):
    config = PipelineConfig()
    config = config.replace(ba=dataclasses.replace(config.ba, num_points=points))
    sel = selection(*request_matches("posed_request_matches", 500), config)
    assert int(sel.weights.sum()) == points
    compare_selection(sel, config.ba)


@pytest.mark.parametrize("loss", ["huber", "l2"])
def test_kernel_source_equals_twin_with_padded_points(lib, loss):
    """Fewer survivors than points: the padded ones weigh 0."""
    ml, mr, nv = scene_case(5, 127, 45)
    sel = selection(ml, mr, nv)
    real = int(sel.weights.sum())
    assert 8 < real < 60 and not bool(sel.weights[real:].any())
    got, want = compare_selection(sel, BundleAdjustmentConfig(loss=loss))
    assert bool(torch.isfinite(want.final_cost).all())


def test_kernel_source_equals_twin_from_a_far_start(lib):
    """A start 2.9 / 20.8 degrees off: one round of 20 steps ends still
    descending, unconverged; and the same with no step at all."""
    ml, mr, nv = request_matches("posed_request_matches", 222)
    s = torch.tensor(FAR_SAMPLE)
    r = eight_point(ml[:, s], mr[:, s], Kt, Kt)
    rot, trans = truth_angles(r.pose)
    assert rot > 2.0 and trans > 15.0
    rr = pransac.RansacResult(r.rotation, r.translation, r.essential, r.pose,
                              torch.cat([s, torch.zeros(8, dtype=s.dtype)]), torch.tensor(nv),
                              torch.tensor(1.0), torch.tensor(True), torch.tensor(True),
                              r.pose, torch.tensor(0.0))
    sel = pose_pipeline.select_points(ml, mr, Kt, Kt, rr, torch.tensor(nv), PipelineConfig())
    got, _ = compare_selection(sel, BundleAdjustmentConfig())
    assert not bool(got.converged.any())
    got, _ = compare_selection(sel, BundleAdjustmentConfig(max_iterations=0))
    assert torch.equal(got.initial_cost, got.final_cost) and bool(got.converged.all())


def test_kernel_source_batch_equals_each_pair_alone(lib):
    sels = [selection(*request_matches(name, 500))
            for name in ("posed_request_matches", "far_winner_request")]
    fields = ("keypoints_left", "keypoints_right", "weights", "rotations", "translations",
              "points")
    both = run_kernel(*(torch.stack([getattr(s, f) for s in sels]) for f in fields[:2]),
                      Kt.expand(2, 3, 3), Kt.expand(2, 3, 3),
                      *(torch.stack([getattr(s, f) for s in sels]) for f in fields[2:]),
                      BundleAdjustmentConfig())
    for i, sel in enumerate(sels):
        alone = run_kernel(*(getattr(sel, f)[None] for f in fields[:2]), Kt[None], Kt[None],
                           *(getattr(sel, f)[None] for f in fields[2:]),
                           BundleAdjustmentConfig())
        for a, b in zip(both, alone):
            assert torch.equal(a[i], b[0])


def test_launcher_refuses_what_the_kernel_does_not_take(lib):
    sel = selection(*request_matches("posed_request_matches", 500))
    args = [sel.keypoints_left[None], sel.keypoints_right[None], Kt[None], Kt[None],
            sel.weights[None], sel.rotations[None], sel.translations[None], sel.points[None]]
    cuda_ba.check(*args, BundleAdjustmentConfig())
    wide = [torch.zeros(1, 3, 129)] * 2 + args[2:4] + [torch.zeros(1, 129)] + args[5:7] + [
        torch.zeros(1, 2, 3, 129)]
    for bad, config in [
        (args, BundleAdjustmentConfig(loss="cauchy")),
        (args, BundleAdjustmentConfig(max_iterations=-1)),
        (wide, BundleAdjustmentConfig()),
        (args[:4] + [args[4].double()] + args[5:], BundleAdjustmentConfig()),
        (args[:5] + [args[5][:, :0]] + args[6:], BundleAdjustmentConfig()),
        (args[:7] + [args[7][..., :10]], BundleAdjustmentConfig()),
    ]:
        with pytest.raises(ValueError):
            cuda_ba.check(*bad, config)
    with pytest.raises(ValueError, match="CUDA"):
        pba.bundle_adjust(sel.keypoints_left, sel.keypoints_right, Kt, Kt.to("meta"),
                          sel.rotations[0], sel.translations[0], sel.points[0])


@pytest.mark.parametrize("field,value", [("num_points", 129), ("num_points", 0),
                                         ("loss", "cauchy")])
def test_the_pose_layer_refuses_a_ba_config_before_sift(lib, monkeypatch, field, value):
    """``check_kernel_config`` raises for the card on what the BA kernel does
    not take, and both posed paths call it before SIFT (RANSAC's half of it,
    whose entry points this module's host build lacks, is
    ``test_torch_ransac_host.py``'s and the card tests')."""
    monkeypatch.setattr(cuda_ransac, "check_config", lambda config, n: None)
    config = PipelineConfig()
    config = config.replace(ba=dataclasses.replace(config.ba, **{field: value}))
    with pytest.raises(ValueError, match="BA kernel"):
        pose_pipeline.check_kernel_config(config, "cuda")
    pose_pipeline.check_kernel_config(config, "cpu")
    pose_pipeline.check_kernel_config(PipelineConfig(), "cuda")

    def as_on_card(config, device):
        pose_pipeline.check_kernel_config(config, "cuda")

    def no_sift(*args, **kwargs):
        raise AssertionError("SIFT ran")

    images = torch.zeros(2, 8, 8, 3, dtype=torch.uint8)
    for module in (pipeline_mod, pipeline_batch):
        monkeypatch.setattr(module, "check_kernel_config", as_on_card)
        monkeypatch.setattr(module, "detect_and_describe_batch", no_sift)
    with pytest.raises(ValueError, match="BA kernel"):
        pipeline_mod.pose_device(images, Kt, Kt, torch.zeros(256, 500), config)
    with pytest.raises(ValueError, match="BA kernel"):
        pipeline_batch._pose_dispatch(images[:1], images[1:], Kt[None], Kt[None],
                                      torch.zeros(1, 256, 500), config)


def test_cpu_route_is_the_plain_twin(lib, monkeypatch):
    """CPU tensors take ``bundle_adjust_plain`` from each start, and no
    launch: the JAX parity tests hold exactly the code they held."""
    monkeypatch.setattr(build, "load_library", lambda: pytest.fail("the library was loaded"))
    sel = selection(*request_matches("far_winner_request", 500))
    before = dict(launch.LAUNCHES)
    solves = pba.bundle_adjust_starts(sel.keypoints_left, sel.keypoints_right, Kt, Kt,
                                      sel.rotations, sel.translations, sel.points, sel.weights)
    for s, got in enumerate(solves):
        want = pba.bundle_adjust_plain(sel.keypoints_left, sel.keypoints_right, Kt, Kt,
                                       sel.rotations[s], sel.translations[s], sel.points[s],
                                       sel.weights)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert dict(launch.LAUNCHES) == before
