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


def test_port_imports_no_jax():
    """Every module of the port, the pose stage's included, imports without
    pulling in jax or the JAX package (whose __init__ imports jax)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import stereo_reconstruction_tpu_torch as p\n"
        "names = [m.name[len(p.__name__) + 1:]\n"
        "         for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        f"missing = set({POSE_MODULES!r}) - set(names)\n"
        "assert not missing, missing\n"
        "for name in names:\n"
        "    importlib.import_module(p.__name__ + '.' + name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'stereo_reconstruction_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
