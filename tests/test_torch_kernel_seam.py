"""The seam between the port's PyTorch code and its CUDA library
(``kernels/launch.py``), on the CPU.

Every public kernel op takes its plain twin for CPU tensors and counts no
launch; a CPU tensor beside one on another kind of device raises
``ValueError`` naming the kernel before the library is loaded; and the C
entry points of ``csrc/*.cu`` are exactly the ones the launchers declare,
each once, with one argument type a C parameter and the C return type.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu_torch.config import MatcherConfig, RansacConfig
from stereo_reconstruction_tpu_torch.kernels import build, launch
from stereo_reconstruction_tpu_torch.kernels.launch import LAUNCHES
from stereo_reconstruction_tpu_torch.ops import cost_volume as tcv
from stereo_reconstruction_tpu_torch.ops import cuda_block_search as cbs
from stereo_reconstruction_tpu_torch.ops import cuda_cost_volume as ccv
from stereo_reconstruction_tpu_torch.ops import cuda_row_scan as crs
from stereo_reconstruction_tpu_torch.ops import smoothing as tsm
from stereo_reconstruction_tpu_torch.ops import warp as twarp
from stereo_reconstruction_tpu_torch.perceptual import scan as pscan
from stereo_reconstruction_tpu_torch.pose import ba as pba
from stereo_reconstruction_tpu_torch.pose import ransac as pransac

PACKAGE = Path(__file__).resolve().parent.parent / "stereo_reconstruction_tpu_torch"
CSRC = PACKAGE / "csrc"
MATCHER = MatcherConfig(block_size=5, max_disparity=8)


def _images():
    rng = np.random.default_rng(0)
    left, right = (torch.from_numpy(rng.integers(0, 256, (10, 20, 3)).astype(np.float32))
                   for _ in range(2))
    return left, right


def _planes():
    left, right = _images()
    cost = tcv.cost_volume_right_ssd(left, right, 5, 0, 8)
    return (*tsm.volume_reductions(cost, 0), tcv.black_pixel_mask(right))


def _matches():
    rng = np.random.default_rng(1)
    K = torch.tensor([[300.0, 0, 40], [0, 300.0, 30], [0, 0, 1]])
    ml, mr = (torch.cat([torch.from_numpy(rng.uniform(0, 80, (2, 24)).astype(np.float32)),
                         torch.ones(1, 24)]) for _ in range(2))
    return ml, mr, K, K


def _ba_problem():
    """Observations of 24 points, the intrinsics, a start (R, T) and the
    points' first guesses."""
    ml, mr, K, _ = _matches()
    R = torch.eye(3)
    T = torch.tensor([-1.0, 0.0, 0.1])
    X = torch.cat([(ml[:2] - 35.0) / 300.0, torch.ones(1, 24)]) * 5.0
    return ml, mr, K, K, R, T, X


def _volume():
    rng = np.random.default_rng(2)
    cost = torch.from_numpy(rng.uniform(0, 1, (4, 6, 12)).astype(np.float32))
    return cost, pscan.weight_table(6, 25.0, 0.85)


RANSAC = RansacConfig(num_hypotheses=8)
# each op: (kernel, inputs, the op on them, its plain twin on them)
OPS = {
    "matcher_inputs": ("K1", _images, lambda l, r: ccv.matcher_inputs(l, r, 5, 0, 8),
                       lambda l, r: ccv.matcher_inputs_plain(l, r, 5, 0, 8)),
    "cost_volume": ("K2", _images, lambda l, r: ccv.cost_volume(l, r, 5, 0, 8),
                    lambda l, r: tcv.cost_volume_right_ssd(l, r, 5, 0, 8)),
    "block_search_fused": ("K3", _images, lambda l, r: cbs.block_search_fused(l, r, MATCHER),
                           lambda l, r: cbs.block_search_fused_plain(l, r, MATCHER)),
    "row_scan": ("K1b", _planes, lambda *p: crs.row_scan(*p, n_planes=8),
                 lambda *p: tsm.smoothed_argmin_from_inputs(*p, n_planes=8)),
    "window_scan": ("K4", _volume, lambda c, t: pscan.window_scan(c, t, 5),
                    lambda c, t: pscan.window_scan_plain(c, t, 5)),
    "warp_inverse_maps": ("warp", _images,
                          lambda l, r: twarp.warp_inverse_maps([l, r], _maps(), (12, 16)),
                          lambda l, r: torch.stack([twarp.warp_inverse_map(x, m, (12, 16))
                                                    for x, m in zip((l, r), _maps())])),
    "ransac_eight_point": ("ransac", _matches,
                           lambda *a: pransac.ransac_eight_point(*a, RANSAC),
                           lambda ml, mr, Kl, Kr: pransac.ransac_plain(
                               ml, mr, Kl, Kr, RANSAC, torch.tensor(ml.shape[-1]),
                               pransac.draw_uniforms(RANSAC, ml.shape[-1]))),
    "bundle_adjust": ("ba", _ba_problem, pba.bundle_adjust, pba.bundle_adjust_plain),
}


def _maps():
    return torch.tensor([[[1.0, 0.02, -1.5], [0.01, 1.0, 0.5], [0.0, 0.0, 1.0]],
                         [[0.98, 0.0, 2.0], [0.0, 1.01, -1.0], [1e-4, 0.0, 1.0]]])


def _no_library():
    raise AssertionError("the kernel library was loaded")


@pytest.mark.parametrize("op", OPS)
def test_cpu_tensors_take_the_twin_and_launch_nothing(op, monkeypatch):
    kernel, inputs, call, twin = OPS[op]
    monkeypatch.setattr(build, "load_library", _no_library)
    args = inputs()
    before = dict(LAUNCHES)
    got, want = call(*args), twin(*args)
    for g, w in zip(*((x,) if isinstance(x, torch.Tensor) else x for x in (got, want))):
        assert torch.equal(g, w), op
    assert dict(LAUNCHES) == before and LAUNCHES[kernel] == 0


@pytest.mark.parametrize("op", OPS)
def test_a_cpu_tensor_beside_a_meta_one_raises_before_the_library(op, monkeypatch):
    kernel, inputs, call, _ = OPS[op]
    monkeypatch.setattr(build, "load_library", _no_library)
    *args, last = inputs()
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match=rf"^{kernel} needs all its tensors on the CPU or on "
                                         r"one CUDA device, got \['cpu', 'meta'\]"):
        call(*args, last.to("meta"))
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("tensors,card", [((), False), ((None,), False),
                                          ((torch.zeros(1), None), False)])
def test_on_card_skips_none(tensors, card):
    assert launch.on_card("K1", *tensors) is card


C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong,
           "const char*": ctypes.c_char_p}


def _c_entry_points():
    """{name: (return type, [parameter types])} of every ``extern "C"`` entry
    point in ``csrc/*.cu``, each type as ctypes declares it."""
    found = {}
    for f in sorted(CSRC.glob("*.cu")):
        for ret, name, params in re.findall(r'extern "C"\s+([\w\s*]+?)\s*\b(stpu_\w+)\(([^)]*)\)',
                                            f.read_text()):
            assert name not in found, f"{name} is defined twice"
            kinds = []
            for p in filter(None, (p.strip() for p in params.split(","))):
                kind = p.rsplit(" ", 1)[0] if "*" not in p else "*"
                kinds.append(ctypes.c_void_p if kind == "*" else
                             C_TYPES[kind.replace("const ", "")])
            found[name] = (C_TYPES[" ".join(ret.split()).replace(" *", "*")], kinds)
    return found


def test_every_c_entry_point_is_declared_once_as_its_source_has_it():
    entries = _c_entry_points()
    assert len(entries) == sum(f.read_text().count('extern "C"') for f in CSRC.glob("*.cu"))
    assert set(launch.SIGNATURES) == set(entries)
    for name, (restype, argtypes) in entries.items():
        assert launch.SIGNATURES[name] == (argtypes, restype), name
    # each name is declared by one ``entry`` call in the package
    sources = "".join(f.read_text() for f in PACKAGE.rglob("*.py"))
    for name in entries:
        assert len(re.findall(rf'\bentry\("{name}"', sources)) == 1, name
    with pytest.raises(ValueError, match="declared twice"):
        launch.entry("stpu_row_scan", [], ctypes.c_int)
