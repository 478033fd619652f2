"""The port's config tree mirrors the JAX package's, and the port package
stays free of JAX."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from stereo_reconstruction_tpu import config as jcfg
from stereo_reconstruction_tpu_torch import config as tcfg

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(__file__), "..")


def test_default_tree_equals_jax():
    assert dataclasses.asdict(tcfg.PipelineConfig()) == dataclasses.asdict(
        jcfg.PipelineConfig())


def test_every_jax_config_class_has_a_twin():
    jax_classes = {n for n, v in vars(jcfg).items()
                   if dataclasses.is_dataclass(v) and isinstance(v, type)}
    port_classes = {n for n, v in vars(tcfg).items()
                    if dataclasses.is_dataclass(v) and isinstance(v, type)}
    assert jax_classes == port_classes


@pytest.mark.parametrize("as_dict", [False, True])
def test_from_jax_config_round_trips(as_dict):
    j = jcfg.PipelineConfig(
        matcher=jcfg.MatcherConfig(block_size=9, max_disparity=64, backend="xla",
                                   var_block_sizes=(9, 13)),
        recon=jcfg.ReconConfig(outlier_kernel=51),
        seed=7,
    )
    got = tcfg.from_jax_config(dataclasses.asdict(j) if as_dict else j)
    assert isinstance(got, tcfg.PipelineConfig)
    assert isinstance(got.matcher, tcfg.MatcherConfig)
    assert got.matcher.var_block_sizes == (9, 13)
    assert dataclasses.asdict(got) == dataclasses.asdict(j)


def test_from_jax_config_rejects_unknown_fields():
    values = dataclasses.asdict(jcfg.PipelineConfig())
    values["matcher"]["no_such_field"] = 1
    with pytest.raises(ValueError, match="no_such_field"):
        tcfg.from_jax_config(values)


def test_backend_strings_kept():
    assert tcfg.MatcherConfig().backend == "auto"
    for backend in ("auto", "pallas", "xla"):
        assert tcfg.MatcherConfig(backend=backend).backend == backend


def test_tf32_pinned_off():
    import stereo_reconstruction_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


POSE_MODULES = ("ops.features", "ops.matching", "ops.geometry", "ops.small_linalg",
                "pose", "pose.eight_point", "pose.ransac", "pose.ba", "pose.pipeline")
ENTRY_MODULES = ("cli", "__main__", "pipeline_batch", "io.calib", "io.native", "io.image",
                 "data.middeval3", "data.hitnet", "utils", "utils.profiling",
                 "utils.batch", "utils.staging")
UNCALIBRATED_MODULES = ("ops.binary_features", "ops.linear_search", "pose.fundamental",
                        "rectify.epilines", "pipeline_uncalibrated")
PERCEPTUAL_MODULES = ("perceptual", "perceptual.vgg", "perceptual.cost", "perceptual.scan",
                      "perceptual.notebook_oracle")
PARALLEL_MODULES = ("parallel", "parallel.mesh", "parallel.sharded", "parallel.ba_dist",
                    "parallel.ba_multiview", "parallel.multihost")
AUX_MODULES = ("recon", "recon.simple_mesh", "utils.debug", "utils.roofline")
REQUIRED_MODULES = (POSE_MODULES + ENTRY_MODULES + UNCALIBRATED_MODULES + PERCEPTUAL_MODULES
                    + PARALLEL_MODULES + AUX_MODULES)


def _no_jax_env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_port_imports_no_jax():
    """Every module of the port, the pose stage's, the entry points', the
    uncalibrated path's, the perceptual matcher's, the multi-device layer's
    (``parallel/``) and the auxiliary ones (``recon/simple_mesh``,
    ``utils/debug``, ``utils/roofline``) included, imports without pulling
    in jax or the JAX package (whose __init__ imports jax).
    ``__main__`` runs the CLI when imported, so it is checked by
    ``test_module_entry_point_help``."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import stereo_reconstruction_tpu_torch as p\n"
        "names = [m.name[len(p.__name__) + 1:]\n"
        "         for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        f"missing = set({REQUIRED_MODULES!r}) - set(names)\n"
        "assert not missing, missing\n"
        "for name in names:\n"
        "    if name != '__main__':\n"
        "        importlib.import_module(p.__name__ + '.' + name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'stereo_reconstruction_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_no_jax_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("argv", [["--help"], ["run", "--help"], ["eval", "--help"],
                                  ["rectify", "--help"]])
def test_module_entry_point_help(argv):
    """``python -m stereo_reconstruction_tpu_torch`` parses its arguments
    (``--device`` defaults to cuda) and imports no JAX on the way."""
    code = (
        "import sys, runpy\n"
        f"sys.argv = ['stereo_reconstruction_tpu_torch'] + {argv!r}\n"
        "try:\n"
        "    runpy.run_module('stereo_reconstruction_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'stereo_reconstruction_tpu']\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_no_jax_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage: stereo_reconstruction_tpu_torch" in out.stdout
    if argv[0] != "--help":
        assert "--device" in out.stdout and "default cuda" in out.stdout
    else:
        for cmd in ("run", "eval", "reconstruct", "rectify", "bench"):
            assert cmd in out.stdout
