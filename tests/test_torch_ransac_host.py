"""The RANSAC kernel's own source, built for the host, against its plain twin.

``csrc/ransac.cuh`` (launched by ``ops/cuda_ransac.py``) runs a warp per
hypothesis and one per pair, its lanes meeting at warp shuffles and
``__syncwarp``. Here the same source is built with the host's C++ compiler
against the stand-ins of ``tests/ransac_host/`` (a CTA's threads as fibers
that meet at every warp-wide operation; ``-ffp-contract=off``) and called
through ctypes on CPU tensors, through the same argument marshalling as the
card (``cuda_ransac.call``).

The twin is ``pose/ransac.py::ransac_plain`` with its rounding pinned to the
kernel's (``ransac_twin.py``, which says why and gives the limits the kernel
is held to, ``compare``).

Cases: the two benchmark fixtures (``data/posed_request_matches.npz``,
``data/far_winner_request.npz``) padded to N = 500; seeded synthetic scenes
with N from 8 to 500 and n_valid < N (one where n_valid < sample_size, so
samples reach past the valid matches); more matches than shared memory
holds the refits' keys for; duplicated matches; a scene with no
cheirality-valid hypothesis; and a batch of two pairs, which must equal
each pair alone bit for bit. Skips where no C++ compiler is found.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu_torch.config import RansacConfig
from stereo_reconstruction_tpu_torch.kernels import build, launch
from stereo_reconstruction_tpu_torch.ops import cuda_ransac
from stereo_reconstruction_tpu_torch.pose import ransac as pransac

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "stereo_reconstruction_tpu_torch", "csrc")
sys.path.insert(0, os.path.join(HERE, ".."))
from chip_smoke import _camera_pair, pose_angles, request_matches  # noqa: E402
from ransac_twin import compare as compare_twin  # noqa: E402

# the benchmark scenes' cameras at 750x900, which both fixtures come from
K, R_TRUE, T_TRUE = _camera_pair(750, 900)
K = K.astype(np.float32)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the RANSAC kernel's source for the host")
    launcher = open(os.path.join(CSRC, "ransac.cu")).read()
    launches = launcher.count("<<<")
    launcher, n = re.subn(r"([\w:]+)<<<(.*?), (.*?), .*?, .*?>>>\((.*?)\);",
                          r"host::launch(\2, \3, [&] { \1(\4); });", launcher, flags=re.S)
    assert n == launches == 2 and "<<<" not in launcher
    out = tmp_path_factory.mktemp("ransac_host")
    shutil.copy(os.path.join(CSRC, "ransac.cuh"), out / "ransac.cuh")
    (out / "ransac.cu").write_text(launcher)
    so = out / "libransac_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-ffp-contract=off",
                    "-pthread", "-I", os.path.join(HERE, "ransac_host"), "-x", "c++",
                    str(out / "ransac.cu"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    launch.declare(lib)
    # the launcher's entry points call the host build for this module's tests
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "load_library", lambda: lib)
        yield lib


def run_kernel(ml, mr, Kl, Kr, n_valid, u, config):
    """The host-built kernel on a batch: (RansacResult with a leading B,
    its scratch)."""
    b, _, n = ml.shape
    out = cuda_ransac.result_buffers((b,), cuda_ransac.support_of(config, n), "cpu")
    scratch = cuda_ransac.scratch_buffers(b, config, n, "cpu")
    cuda_ransac.check(ml, mr, Kl, Kr, n_valid, u, config)
    rc = cuda_ransac.call(*(t.contiguous() for t in (ml, mr, Kl, Kr, n_valid, u)), config,
                          out, scratch, None)
    assert rc == 0, f"host launch refused: {rc}"
    return pransac.RansacResult(*out), scratch


def homogeneous(xy):
    return torch.from_numpy(np.concatenate([xy.T, np.ones((1, len(xy)), np.float32)]))


def scene_case(seed, n, n_valid, outliers=0.2, behind=0.0, duplicates=1):
    """Matches of a seeded two-view scene (the benchmark's cameras), 0.3 px
    of noise, a share of outliers, n - n_valid padding pixels; a share
    ``behind`` of the points lies behind both cameras; each valid match
    repeated ``duplicates`` times."""
    rng = np.random.default_rng(seed)
    distinct = -(-n_valid // duplicates)
    z = rng.uniform(4.0, 12.0, distinct)
    X = np.stack([rng.uniform(-2.5, 2.5, distinct) * z / 6, rng.uniform(-2, 2, distinct) * z / 6,
                  z])
    X[:, rng.uniform(size=distinct) < behind] *= -1

    def project(P):
        p = K.astype(np.float64) @ P
        return (p[:2] / p[2]).T

    left = project(X)
    right = project(R_TRUE @ X + T_TRUE[:, None]) + rng.normal(0, 0.3, (distinct, 2))
    bad = rng.uniform(size=distinct) < outliers
    right[bad] = rng.uniform(0, 900, (int(bad.sum()), 2))
    left = np.repeat(left, duplicates, axis=0)[:n_valid]
    right = np.repeat(right, duplicates, axis=0)[:n_valid]
    pad = rng.uniform(0, 900, (2, n - n_valid, 2))
    ml = homogeneous(np.concatenate([left, pad[0]]).astype(np.float32))
    mr = homogeneous(np.concatenate([right, pad[1]]).astype(np.float32))
    return ml, mr, n_valid


def compare(kernel, ml, mr, n_valid, config, device="cpu", seed=3):
    """``ransac_twin.compare`` on draws of ``seed`` and the benchmark
    scenes' cameras; (the kernel's result, the twin's)."""
    u = pransac.draw_uniforms(config, ml.shape[-1], torch.Generator().manual_seed(seed))
    got, want, _ = compare_twin(kernel, ml, mr, n_valid, config, torch.from_numpy(K), u, device)
    return got, want


def truth_angles(pose):
    """(rotation, translation direction) degrees of a pose from the
    benchmark scenes' cameras."""
    return pose_angles(pose.detach().cpu().numpy(), R_TRUE, T_TRUE)


@pytest.mark.parametrize("name", ["posed_request_matches", "far_winner_request"])
def test_kernel_source_equals_twin_on_the_fixtures(lib, name):
    ml, mr, nv = request_matches(name, 500)
    got, _ = compare(run_kernel, ml, mr, nv, RansacConfig())
    assert bool(got.valid[0]) and int(got.inlier_count[0]) == nv


@pytest.mark.parametrize("seed,n,n_valid", [
    (1, 8, 8), (2, 12, 6), (3, 20, 17), (4, 40, 31), (5, 127, 100), (6, 260, 200),
    (7, 500, 333),
])
def test_kernel_source_equals_twin_on_scenes(lib, seed, n, n_valid):
    ml, mr, nv = scene_case(seed, n, n_valid)
    compare(run_kernel, ml, mr, nv, RansacConfig())


def test_kernel_source_equals_twin_past_shared_keys(lib):
    """More matches than shared memory holds the refits' sort keys for: the
    keys go to the (B, N) scratch."""
    n = cuda_ransac.shared_keys() + 100
    ml, mr, nv = scene_case(9, n, 300)
    compare(run_kernel, ml, mr, nv, RansacConfig(num_hypotheses=64))


def test_kernel_source_equals_twin_on_duplicated_matches(lib):
    ml, mr, nv = scene_case(8, 300, 240, duplicates=3)
    compare(run_kernel, ml, mr, nv, RansacConfig())


def test_kernel_source_equals_twin_with_no_valid_hypothesis(lib):
    # half the points behind both cameras: every mixed sample is invalid (this
    # seed draws no sample of one kind alone)
    ml, mr, nv = scene_case(17, 120, 100, outliers=0.0, behind=0.5)
    got, want = compare(run_kernel, ml, mr, nv, RansacConfig(num_hypotheses=64))
    assert not bool(want.valid) and not bool(got.valid[0])


@pytest.mark.parametrize("name", ["posed_request_matches", "far_winner_request"])
def test_kernel_source_then_ba_poses_the_fixtures(lib, name):
    """The benchmark's two hard requests: the kernel's RANSAC, then
    ``refine_pose`` and ``settle_pose``, within the configuration's 0.5 / 2
    degrees for each of two draws (the card's form is in
    ``test_torch_cuda.py``)."""
    from stereo_reconstruction_tpu_torch.config import PipelineConfig
    from stereo_reconstruction_tpu_torch.pose.pipeline import refine_pose, settle_pose

    cfg = PipelineConfig()
    ml, mr, nv = request_matches(name, 500)
    Kt = torch.from_numpy(K)
    for seed in range(2):
        u = pransac.draw_uniforms(cfg.ransac, 500, torch.Generator().manual_seed(seed))
        rr, _ = run_kernel(ml[None], mr[None], Kt[None], Kt[None], torch.tensor([nv]),
                           u[None], cfg.ransac)
        rr = pransac.RansacResult(*(x[0] for x in rr))
        est = settle_pose(refine_pose(ml, mr, Kt, Kt, rr, torch.tensor(nv), cfg), Kt, Kt, cfg)
        rot, trans = truth_angles(est.pose)
        assert bool(est.valid) and rot <= 0.5 and trans <= 2.0, (seed, rot, trans)


def test_kernel_source_batch_equals_each_pair_alone(lib):
    config = RansacConfig(num_hypotheses=64)
    cases = [scene_case(10, 200, 150), scene_case(11, 200, 180)]
    Kt = torch.from_numpy(K)
    u = torch.stack([pransac.draw_uniforms(config, 200, torch.Generator().manual_seed(s))
                     for s in (1, 2)])
    nv = torch.tensor([c[2] for c in cases])
    both, _ = run_kernel(torch.stack([c[0] for c in cases]),
                         torch.stack([c[1] for c in cases]), Kt.expand(2, 3, 3),
                         Kt.expand(2, 3, 3), nv, u, config)
    for i, (ml, mr, _) in enumerate(cases):
        alone, _ = run_kernel(ml[None], mr[None], Kt[None], Kt[None], nv[i:i + 1],
                              u[i:i + 1], config)
        for a, b in zip(both, alone):
            assert torch.equal(a[i], b[0])


def test_launcher_refuses_what_the_kernel_does_not_take(lib):
    Kt = torch.from_numpy(K)[None]
    ml, mr, _ = scene_case(12, 40, 30)
    u = torch.rand(1, 256, 40)
    nv = torch.tensor([30])
    for config, args in [
        (RansacConfig(sample_size=33), (ml[None], mr[None], Kt, Kt, nv, u)),
        (RansacConfig(refine_support=40), (ml[None], mr[None], Kt, Kt, nv, u)),
        (RansacConfig(), (ml[None], mr[None], Kt, Kt, nv.int(), u)),
        (RansacConfig(), (ml[None], mr[None], Kt.double(), Kt, nv, u)),
        (RansacConfig(), (ml[None], mr[None], Kt, Kt, nv, u[:, :10])),
        (RansacConfig(), (ml[None, :, :6], mr[None, :, :6], Kt, Kt, nv, u[..., :6])),
        (RansacConfig(num_hypotheses=0), (ml[None], mr[None], Kt, Kt, nv, u[:, :0])),
    ]:
        with pytest.raises(ValueError):
            cuda_ransac.check(*args, config)
    with pytest.raises(ValueError, match="CUDA"):
        pransac.ransac_eight_point(ml, mr, Kt[0], Kt[0].to("meta"))
