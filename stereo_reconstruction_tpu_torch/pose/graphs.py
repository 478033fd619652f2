"""The card's pose stage after SIFT, replayed from CUDA graphs.

After SIFT the pose stage is some 3k small kernels a pair besides its two
hand-written ones, each launched from Python: the card would wait on the
host most of the time, so a pair's time would follow the host's speed.
``PoseGraphs`` records those launches once as four CUDA graphs and then
replays them, one launch each, with the kernels launched between them (so
``kernels/launch.py::LAUNCHES`` counts every launch that runs):

* ``match``: ``match_descriptors`` and ``valid_first`` (span ``pose.match``);
* RANSAC: the kernel (``ops/cuda_ransac.py``, two launches, not a graph;
  span ``pose.ransac``), from ``match``'s outputs and the draws into the
  buffers that ``select`` reads;
* ``select``: ``select_points``, the triangulation, the filter and BA's
  two starts (span ``pose.ba``, as the next two);
* BA: the kernel (``ops/cuda_ba.py``, one launch for both starts);
* ``choose``: ``choose_pose``, the choice between the two solves and both
  reprojection errors;
* a further round of ``settle_pose``: the BA kernel's one launch, then
  the graph ``round``, its reprojection error (``round_result``).

The graphs run the eager path's kernels on the same inputs, so their
outputs equal it bit for bit. Each reads fixed input buffers and writes
fixed outputs: a call copies its inputs in and its outputs out, and the
graphs and kernels chain through each other's outputs.
One set is captured per (device, configuration, keypoint and image
shapes) and kept, with its memory pool, for the life of the process
(``pose_graphs``); capture runs each stage once eagerly first, so a first
call costs about two eager calls. The spans are given the device, so
that a traced request records their device time.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from stereo_reconstruction_tpu_torch.config import PipelineConfig
from stereo_reconstruction_tpu_torch.ops import cuda_ba, cuda_ransac
from stereo_reconstruction_tpu_torch.ops.features import Keypoints
from stereo_reconstruction_tpu_torch.ops.matching import match_descriptors, valid_first
from stereo_reconstruction_tpu_torch.pose.ba import SETTLE_RTOL, SETTLE_WINDOW, BAResult
from stereo_reconstruction_tpu_torch.pose.pipeline import PoseEstimate, Selection, \
    choose_pose, round_result, select_points
from stereo_reconstruction_tpu_torch.pose.ransac import RansacResult
from stereo_reconstruction_tpu_torch.utils.profiling import span


class _Graph:
    """``fn`` over the fixed tensors ``inputs``, run once eagerly on a
    side stream (which loads its kernels and sets up the libraries it
    calls), then captured into ``pool``; ``outputs`` is what the capture
    returned, rewritten by each ``replay``."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], pool):
        device = inputs[0].device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(*inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.outputs = fn(*inputs)
        self.graph.replay()

    def replay(self):
        self.graph.replay()
        return self.outputs


class PoseGraphs:
    """The pose stage of one pair from SIFT's output on, as graphs
    captured from the keypoints, intrinsics and draws of a first call."""

    def __init__(self, kp: Keypoints, K_left: torch.Tensor, K_right: torch.Tensor,
                 uniforms: torch.Tensor, config: PipelineConfig):
        self.device = K_left.device
        self.kp = Keypoints(*(x.clone() for x in kp))
        self.K_left, self.K_right = K_left.clone(), K_right.clone()
        self.uniforms = uniforms.clone()
        pool = torch.cuda.graph_pool_handle()

        def match(*kp):
            return valid_first(match_descriptors(Keypoints(*(x[0] for x in kp)),
                                                 Keypoints(*(x[1] for x in kp)),
                                                 config.frontend))

        n_rr, n_sel = len(RansacResult._fields), len(Selection._fields)

        def select(ml, mr, n_valid, *rr):
            return tuple(select_points(ml, mr, self.K_left, self.K_right, RansacResult(*rr),
                                       n_valid, config))

        def choose(ml, mr, n_valid, *args):
            rr, sel, ba = args[:n_rr], args[n_rr:n_rr + n_sel], args[n_rr + n_sel:]
            solves = [BAResult(*(x[0, s] for x in ba)) for s in range(2)]
            return tuple(choose_pose(ml, mr, self.K_left, self.K_right, RansacResult(*rr),
                                     n_valid, Selection(*sel), *solves, config))

        def error(kl, kr, weights, *ba):
            return round_result(kl, kr, self.K_left, self.K_right,
                                BAResult(*(x[0, 0] for x in ba)), weights)

        self.match = _Graph(match, list(self.kp), pool)
        ml, mr, n_valid = self.match.outputs
        n = ml.shape[-1]
        # the kernel's batch of one: views of the match outputs, intrinsics
        # and draws, its results written into fixed buffers
        self.ransac_in = (ml[None], mr[None], self.K_left[None], self.K_right[None],
                          n_valid.reshape(1), self.uniforms[None])
        self.ransac_config = config.ransac
        self.rr = cuda_ransac.result_buffers((), cuda_ransac.support_of(config.ransac, n),
                                             self.device)
        self.ransac_out = [x[None] for x in self.rr]
        self.ransac_scratch = cuda_ransac.scratch_buffers(1, config.ransac, n, self.device)
        self._ransac()
        self.ba_config = config.ba
        m = config.ba.num_points
        self.select = _Graph(select, [ml, mr, n_valid, *self.rr], pool)
        sel = Selection(*self.select.outputs)
        # the kernel's batch of one pair from two starts
        self.ba_in = (sel.keypoints_left[None], sel.keypoints_right[None], self.K_left[None],
                      self.K_right[None], sel.weights[None], sel.rotations[None],
                      sel.translations[None], sel.points[None])
        self.ba_out = cuda_ba.result_buffers((1, 2), m, self.device)
        self._ba(self.ba_in, self.ba_out)
        self.choose = _Graph(choose, [ml, mr, n_valid, *self.rr, *sel, *self.ba_out], pool)
        est = PoseEstimate(*self.choose.outputs)
        # a further round: the pair's points and weights, one start
        self.round_obs = [x.clone() for x in (est.keypoints_left, est.keypoints_right,
                                              est.weights)]
        self.round_start = (est.pose[None, None, :3, :3].clone(),
                            est.pose[None, None, :3, 3].clone(), est.points[None, None].clone())
        kl, kr, weights = self.round_obs
        self.round_in = (kl[None], kr[None], self.K_left[None], self.K_right[None],
                         weights[None], *self.round_start)
        self.round_out = cuda_ba.result_buffers((1, 1), m, self.device)
        self._ba(self.round_in, self.round_out)
        self.round = _Graph(error, [kl, kr, weights, *self.round_out], pool)

    def __call__(self, kp: Keypoints, K_left: torch.Tensor, K_right: torch.Tensor,
                 uniforms: torch.Tensor) -> PoseEstimate:
        """The first BA round's ``PoseEstimate`` (``pose_from_keypoints``'s),
        its tensors the caller's own."""
        for static, x in zip(self.kp, kp):
            static.copy_(x)
        self.K_left.copy_(K_left)
        self.K_right.copy_(K_right)
        self.uniforms.copy_(uniforms)
        with span("pose.match", self.device):
            self.match.replay()
        with span("pose.ransac", self.device):
            self._ransac()
        with span("pose.ba", self.device):
            self.select.replay()
            self._ba(self.ba_in, self.ba_out)
            est = self.choose.replay()
        return PoseEstimate(*(x.clone() for x in est))

    def _ransac(self):
        cuda_ransac.ransac(*self.ransac_in, self.ransac_config, self.ransac_out,
                           self.ransac_scratch)

    def _ba(self, inputs, out):
        cuda_ba.bundle_adjust(*inputs, self.ba_config, SETTLE_WINDOW, SETTLE_RTOL, out)

    def step(self, kp_left, kp_right, K_left, K_right, pose, points, weights):
        """``ba_round`` as the kernel's launch and the replayed graph, for
        ``settle_pose``'s ``step``; the intrinsics are those of the last
        call."""
        for static, x in zip((*self.round_obs, *self.round_start),
                             (kp_left, kp_right, weights, pose[:3, :3], pose[:3, 3], points)):
            static.copy_(x)
        self._ba(self.round_in, self.round_out)
        return tuple(x.clone() for x in self.round.replay())


_CACHE: Dict[tuple, PoseGraphs] = {}


def pose_graphs(kp: Keypoints, K_left: torch.Tensor, K_right: torch.Tensor,
                uniforms: torch.Tensor, config: PipelineConfig) -> PoseGraphs:
    """The ``PoseGraphs`` of these shapes, configuration and device,
    captured from these inputs the first time they are asked for."""
    key = (K_left.device, config, uniforms.shape,
           tuple(tuple(x.shape) + (x.dtype,) for x in kp))
    graphs = _CACHE.get(key)
    if graphs is None:
        graphs = _CACHE[key] = PoseGraphs(kp, K_left, K_right, uniforms, config)
    return graphs
