"""The parts of the port's pose stage that the card's CUDA graphs
(``pose/graphs.py``) are built from, on the CPU: shared constants that
make no copy from the host, ``valid_first``, RANSAC followed by
``refine_pose`` as ``estimate_pose_from_matches`` runs them, and
``settle_pose`` with a round run in ``ba_round``'s place. The graphs
themselves run only on a card (``tests/test_torch_cuda.py``)."""

import os

import numpy as np
import torch

from stereo_reconstruction_tpu.config import BundleAdjustmentConfig, PipelineConfig
from stereo_reconstruction_tpu_torch.config import from_jax_config
from stereo_reconstruction_tpu_torch.ops import geometry as geo
from stereo_reconstruction_tpu_torch.ops.matching import Matches, valid_first
from stereo_reconstruction_tpu_torch.pose import pipeline as pose_pipeline
from stereo_reconstruction_tpu_torch.pose.ransac import draw_uniforms, ransac_eight_point

DATA = os.path.join(os.path.dirname(__file__), "data", "posed_request_matches.npz")
K = torch.tensor([[900.0, 0, 450.0], [0, 900.0, 375.0], [0, 0, 1]])
CONFIG = from_jax_config(PipelineConfig())


def _matches():
    d = np.load(DATA)
    ones = np.ones((1, len(d["left"])), np.float32)
    return (torch.from_numpy(np.concatenate([d["left"].T, ones])),
            torch.from_numpy(np.concatenate([d["right"].T, ones])))


def test_a_constant_is_made_once_per_value_dtype_and_device():
    values = ((0.0, -1.0), (1.0, 0.5))
    a = geo.constant(values, torch.float32, "cpu")
    assert a is geo.constant(values, torch.float32, torch.device("cpu"))
    assert torch.equal(a, torch.tensor(values, dtype=torch.float32))
    b = geo.constant(values, torch.float64, "cpu")
    assert b is not a and b.dtype == torch.float64


def test_valid_first_moves_the_valid_matches_to_the_front_in_order():
    xy = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    valid = torch.tensor([False, True, False, True, True, False])
    left, right, n_valid = valid_first(Matches(xy, xy + 100, torch.zeros(6), valid))
    assert int(n_valid) == 3
    assert left.shape == (3, 6) and torch.equal(left[2], torch.ones(6))
    assert torch.equal(left[:2, :3].T, xy[[1, 3, 4]])
    assert torch.equal(right[:2, 3:].T, xy[[0, 2, 5]] + 100)


def test_ransac_then_refine_pose_is_estimate_pose_from_matches():
    ml, mr = _matches()
    u = draw_uniforms(CONFIG.ransac, ml.shape[1], torch.Generator().manual_seed(3))
    n_valid = torch.tensor(ml.shape[1] - 5)
    want = pose_pipeline.estimate_pose_from_matches(ml, mr, K, K, CONFIG, n_valid, u)
    rr = ransac_eight_point(ml, mr, K, K, CONFIG.ransac, n_valid, u)
    got = pose_pipeline.refine_pose(ml, mr, K, K, rr, n_valid, CONFIG)
    for field in want._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field


def test_settle_pose_runs_a_given_step_in_ba_rounds_place():
    ml, mr = _matches()
    # rounds of 4 steps leave BA descending, so settling runs further rounds
    short = from_jax_config(PipelineConfig(ba=BundleAdjustmentConfig(max_iterations=4)))
    est = pose_pipeline.estimate_pose_from_matches(ml, mr, K, K, short)
    assert not bool(est.ba_converged)
    calls = []

    def step(*args):
        calls.append(len(args))
        return pose_pipeline.ba_round(*args, short)

    got = pose_pipeline.settle_pose(est, K, K, short, step=step)
    want = pose_pipeline.settle_pose(est, K, K, short)
    assert calls and set(calls) == {7}
    for field in want._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
