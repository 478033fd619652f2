"""Command-line interface: ``python -m stereo_reconstruction_tpu_torch <cmd>``.

Port of ``stereo_reconstruction_tpu/cli.py`` with the same subcommands,
arguments and JSON lines, plus ``--device`` (default ``cuda``; without a
card the run raises, ``--device cpu`` runs on the CPU):

  run          full reconstruction of one or more MiddEval3 scenarios,
               one at a time (``pipeline.run_pair``) or, with ``--batch``,
               as one batch (``pipeline_batch.run_batch``)
  eval         disparity metrics of a PFM against GT and a nocc mask
  reconstruct  the RUN_ALL=0 path: mesh a precomputed disparity map
  rectify      the uncalibrated ORB+F pipeline of one scenario
               (``pipeline_uncalibrated.run_uncalibrated``)
  bench        not ported yet (NotImplementedError)

``run --matcher`` takes ssd, sad, ncc and perceptual (the VGG/LPIPS
search; ``--weights`` names a converted ``.npz``, else the seeded He-init
weights).

Example:
  python -m stereo_reconstruction_tpu_torch run --data MiddEval3 \\
      --scenario 13 --out results/ --mesh
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="stereo_reconstruction_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_arg(p):
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu runs without a card)")

    run_p = sub.add_parser("run", help="full pipeline on scenarios")
    run_p.add_argument("--data", required=True, help="MiddEval3 root")
    run_p.add_argument("--scenario", type=int, nargs="+", default=[13])
    run_p.add_argument("--split", default="training", choices=["training", "test"])
    run_p.add_argument("--out", default="results")
    run_p.add_argument("--mesh", action="store_true")
    run_p.add_argument("--downsample", type=int, default=1)
    run_p.add_argument("--max-disparity", type=int, default=200)
    run_p.add_argument("--matcher", default="ssd",
                       choices=["ssd", "sad", "ncc", "perceptual"],
                       help="dense matching cost")
    run_p.add_argument("--weights", default="",
                       help="converted VGG/LPIPS weights .npz for --matcher perceptual")
    run_p.add_argument("--png-compat", action="store_true",
                       help="quantize disparity through uint8 PNG like the reference")
    run_p.add_argument("--batch", action="store_true",
                       help="run all scenarios as one batch (pipeline_batch.run_batch)")
    device_arg(run_p)

    eval_p = sub.add_parser("eval", help="score a disparity PFM against GT")
    eval_p.add_argument("--disp", required=True)
    eval_p.add_argument("--gt", required=True)
    eval_p.add_argument("--mask", required=True)
    eval_p.add_argument("--bad-thresh", type=float, default=2.0)
    eval_p.add_argument("--max-disp", type=float, default=1e9)
    device_arg(eval_p)

    rect_p = sub.add_parser(
        "rectify", help="uncalibrated ORB+F pipeline (reference rectification_main)")
    rect_p.add_argument("--data", required=True, help="MiddEval3 root")
    rect_p.add_argument("--scenario", type=int, default=13)
    rect_p.add_argument("--split", default="training", choices=["training", "test"])
    rect_p.add_argument("--out", default="results/rectified")
    rect_p.add_argument("--detector", default="orb", choices=["orb", "brisk", "dog"])
    rect_p.add_argument("--downsample", type=int, default=1)
    rect_p.add_argument("--max-disparity", type=int, default=200)
    device_arg(rect_p)

    hit_p = sub.add_parser(
        "reconstruct", help="RUN_ALL=0 path: mesh a precomputed disparity map")
    hit_p.add_argument("--data", required=True, help="MiddEval3 root")
    hit_p.add_argument("--results", required=True,
                       help="precomputed results root (e.g. results/HitNet)")
    hit_p.add_argument("--scenario", type=int, default=13)
    hit_p.add_argument("--out", default="results/reconstruction_mesh.off")
    hit_p.add_argument("--no-gt-rescale", action="store_true")
    device_arg(hit_p)

    bench_p = sub.add_parser("bench", help="throughput benchmark (not ported yet)")
    bench_p.add_argument("--quick", action="store_true")

    args = ap.parse_args(argv)
    {"run": _cmd_run, "eval": _cmd_eval, "rectify": _cmd_rectify,
     "reconstruct": _cmd_reconstruct, "bench": _cmd_bench}[args.cmd](args)


def _load_pairs(args):
    from stereo_reconstruction_tpu_torch.data import MiddEval3
    from stereo_reconstruction_tpu_torch.data.middeval3 import downsample_pair

    ds = MiddEval3(args.data)
    for idx in args.scenario:
        pair = ds.load_training(idx) if args.split == "training" else ds.load_test(idx)
        for _ in range(max(0, args.downsample - 1)):
            pair = downsample_pair(pair)
        yield pair


def _cmd_run(args):
    from stereo_reconstruction_tpu_torch.config import PipelineConfig

    config = PipelineConfig()
    config = config.replace(
        matcher=dataclasses.replace(config.matcher, max_disparity=args.max_disparity,
                                    cost=args.matcher),
        perceptual=dataclasses.replace(config.perceptual, weights_path=args.weights),
    )

    if args.batch:
        from stereo_reconstruction_tpu_torch.pipeline_batch import run_batch

        pairs = list(_load_pairs(args))
        res = run_batch(pairs, config, device=args.device)
        for pair, m in zip(pairs, res.metrics):
            print(json.dumps({"scenario": pair.name, **m, "timings": res.timings}))
        return

    from stereo_reconstruction_tpu_torch.pipeline import run_pair

    for pair in _load_pairs(args):
        result = run_pair(pair, config, output_dir=args.out, write_mesh=args.mesh,
                          png_compat=args.png_compat, device=args.device)
        print(json.dumps({
            "scenario": pair.name,
            "metrics": result.metrics,
            "timings": {k: round(v, 3) for k, v in result.timings.items()},
        }))


def _cmd_eval(args):
    import torch

    from stereo_reconstruction_tpu_torch.io import read_image, read_pfm
    from stereo_reconstruction_tpu_torch.ops.metrics import evaldisp
    from stereo_reconstruction_tpu_torch.pipeline import _device

    device = _device(args.device)
    disp, gt = read_pfm(args.disp), read_pfm(args.gt)
    mask = read_image(args.mask, grayscale=True)
    m = evaldisp(*(torch.as_tensor(np.asarray(a), device=device) for a in (disp, gt, mask)),
                 bad_thresh=args.bad_thresh, max_disp=args.max_disp)
    print(json.dumps({k: float(v) for k, v in m.items()}))


def _cmd_rectify(args):
    from stereo_reconstruction_tpu_torch.config import PipelineConfig
    from stereo_reconstruction_tpu_torch.pipeline_uncalibrated import run_uncalibrated

    config = PipelineConfig()
    config = config.replace(
        matcher=dataclasses.replace(config.matcher, max_disparity=args.max_disparity))
    args.scenario = [args.scenario]
    pair = next(_load_pairs(args))
    res = run_uncalibrated(np.asarray(pair.image_left), np.asarray(pair.image_right),
                           config, detector=args.detector, output_dir=args.out,
                           device=args.device)
    print(json.dumps({
        "scenario": pair.name,
        "num_inliers": res.num_inliers,
        "F": np.asarray(res.F).tolist(),
        "F_rectified": None if res.F_rectified is None else np.asarray(
            res.F_rectified).tolist(),
    }))


def _cmd_reconstruct(args):
    from stereo_reconstruction_tpu_torch.config import PipelineConfig
    from stereo_reconstruction_tpu_torch.data import (
        MiddEval3,
        PrecomputedDisparities,
        rescale_to_gt_mean,
    )
    from stereo_reconstruction_tpu_torch.pipeline import reconstruct_from_disparity

    pair = MiddEval3(args.data).load_training(args.scenario)
    disp = PrecomputedDisparities(args.results).load_training(args.scenario)
    if not args.no_gt_rescale and pair.disp_left_gt is not None:
        disp = rescale_to_gt_mean(disp, pair.disp_left_gt)
    _, depth = reconstruct_from_disparity(pair, disp, PipelineConfig(),
                                          output_path=args.out, device=args.device)
    print(json.dumps({"scenario": pair.name, "mesh": args.out,
                      "depth_valid_frac": float((depth > 0).mean())}))


def _cmd_bench(args):
    raise NotImplementedError(
        "bench is not ported yet: the port's benchmark comes in its own PR "
        "(ROADMAP Queue 1 item 2, 'the port's benchmark')")


if __name__ == "__main__":
    main()
