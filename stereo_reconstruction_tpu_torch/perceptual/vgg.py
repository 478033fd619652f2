"""VGG-16 feature extractor (the LPIPS backbone) in PyTorch.

Port of ``stereo_reconstruction_tpu/perceptual/vgg.py``: the five feature
stages relu1_2, relu2_2, relu3_3, relu4_3, relu5_3 (channels
64/128/256/512/512, strides 1/2/4/8/16) of the reference notebook's
``lpips.LPIPS(net='vgg')`` tower, preceded by the LPIPS input scaling
layer. The tower is a ``VGG16Features`` module of ``nn.Conv2d`` (3x3, SAME
padding) + ReLU + 2x2 max pools; the host functions (weight init, the
``.npz`` layout, the torch-LPIPS conversion) are NumPy copies of the JAX
package's, so the seeded He-init weights are the same arrays bit for bit.

Parameters travel in the JAX package's layout, a dict
``{"convs": [[(w, b), ...] per block], "lins": [lin per stage]}`` of NumPy
arrays; ``VGG16Features.from_params`` loads it into a module on a device,
and ``vgg_module`` caches that module per ``(weights_path, seed,
device)``. Every function that takes ``params`` accepts the dict or a
module.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stereo_reconstruction_tpu_torch.ops.cost_volume import sqrt_rn

# (out_channels, num_convs) per VGG-16 block; stage taps after each block
VGG16_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
STAGE_CHANNELS = (64, 128, 256, 512, 512)
STAGE_STRIDES = (1, 2, 4, 8, 16)

# LPIPS scaling layer constants (inputs are RGB in [-1, 1])
_LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def init_vgg16_params(seed: int = 0, with_lins: bool = True) -> Dict:
    """Deterministic He-initialised VGG-16 conv stack + unit lin weights
    (the JAX package's arrays, bit for bit)."""
    rng = np.random.default_rng(seed)
    params: Dict = {"convs": [], "lins": []}
    in_ch = 3
    for out_ch, n_convs in VGG16_BLOCKS:
        block = []
        for _ in range(n_convs):
            fan_in = 3 * 3 * in_ch
            w = rng.normal(0, np.sqrt(2.0 / fan_in), (out_ch, in_ch, 3, 3))
            b = np.zeros((out_ch,))
            block.append((w.astype(np.float32), b.astype(np.float32)))
            in_ch = out_ch
        params["convs"].append(block)
    if with_lins:
        for ch in STAGE_CHANNELS:
            params["lins"].append(np.full((ch,), 1.0 / ch, np.float32))
    return params


@functools.lru_cache(maxsize=4)
def get_params(weights_path: str = "", seed: int = 0) -> Dict:
    """Converted LPIPS weights when a path is given, else the seeded He-init
    weights (nothing is downloaded)."""
    if weights_path:
        return load_params_npz(weights_path)
    return init_vgg16_params(seed)


def save_params_npz(path: str, params: Dict) -> None:
    flat = {}
    for bi, block in enumerate(params["convs"]):
        for ci, (w, b) in enumerate(block):
            flat[f"conv_{bi}_{ci}_w"] = np.asarray(w)
            flat[f"conv_{bi}_{ci}_b"] = np.asarray(b)
    for li, lin in enumerate(params.get("lins", [])):
        flat[f"lin_{li}"] = np.asarray(lin)
    np.savez(path, **flat)


def load_params_npz(path: str) -> Dict:
    data = np.load(path)
    params: Dict = {"convs": [], "lins": []}
    for bi, (_, n_convs) in enumerate(VGG16_BLOCKS):
        block = []
        for ci in range(n_convs):
            block.append((data[f"conv_{bi}_{ci}_w"], data[f"conv_{bi}_{ci}_b"]))
        params["convs"].append(block)
    li = 0
    while f"lin_{li}" in data:
        params["lins"].append(data[f"lin_{li}"])
        li += 1
    return params


def convert_torch_lpips(state_dict) -> Dict:
    """Convert a torch LPIPS(net='vgg') state dict: ``net.slice{1..5}.<idx>``
    (or ``net.features.<idx>``) weight/bias for the VGG convs and
    ``lins.{0..4}.model.1.weight`` for the 1x1 lin layers."""
    params: Dict = {"convs": [], "lins": []}
    # vgg16.features indices of the convs of each block
    conv_idx = [(0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28)]
    for bi, idxs in enumerate(conv_idx):
        block = []
        for idx in idxs:
            w = None
            for key in (f"net.slice{bi+1}.{idx}.weight", f"net.features.{idx}.weight"):
                if key in state_dict:
                    w = np.asarray(state_dict[key])
                    b = np.asarray(state_dict[key.replace("weight", "bias")])
                    break
            if w is None:
                raise KeyError(f"conv weight for block {bi} idx {idx} not found")
            block.append((w.astype(np.float32), b.astype(np.float32)))
        params["convs"].append(block)
    for li in range(5):
        key = f"lins.{li}.model.1.weight"
        if key in state_dict:
            params["lins"].append(np.asarray(state_dict[key]).reshape(-1).astype(np.float32))
    return params


class VGG16Features(nn.Module):
    """The conv/pool tower on pre-scaled (N, 3, H, W) input: each block's
    3x3 convs (SAME padding) with ReLU, its output kept as a stage, then a
    2x2 stride-2 max pool (floor, as ``reduce_window`` VALID) between
    blocks. ``lins`` are the LPIPS stage weights ([] when the weights carry
    none). Any widths: they come from the weights."""

    def __init__(self, blocks: Sequence[Sequence[int]], lins: Sequence[torch.Tensor] = ()):
        super().__init__()
        self.blocks = nn.ModuleList()
        in_ch = 3
        for widths in blocks:
            convs = nn.ModuleList()
            for out_ch in widths:
                convs.append(nn.Conv2d(in_ch, out_ch, 3, padding=1))
                in_ch = out_ch
            self.blocks.append(convs)
        for i, lin in enumerate(lins):
            self.register_buffer(f"lin_{i}", lin)
        self.n_lins = len(lins)
        self.requires_grad_(False)

    @classmethod
    def from_params(cls, params: Dict, device="cpu") -> "VGG16Features":
        """The module of a JAX-layout parameter dict (NumPy or anything
        ``np.asarray`` takes), on ``device``."""
        blocks = [[int(np.shape(w)[0]) for w, _ in block] for block in params["convs"]]
        lins = [torch.from_numpy(np.asarray(lin, np.float32).copy())
                for lin in params.get("lins") or []]
        module = cls(blocks, lins)
        with torch.no_grad():
            for convs, block in zip(module.blocks, params["convs"]):
                for conv, (w, b) in zip(convs, block):
                    conv.weight.copy_(torch.from_numpy(np.asarray(w, np.float32)))
                    conv.bias.copy_(torch.from_numpy(np.asarray(b, np.float32)))
        return module.to(device)

    @property
    def device(self) -> torch.device:
        return self.blocks[0][0].weight.device

    @property
    def lins(self) -> List[torch.Tensor]:
        return [getattr(self, f"lin_{i}") for i in range(self.n_lins)]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        stages = []
        for bi, convs in enumerate(self.blocks):
            for conv in convs:
                x = F.relu(conv(x))
            stages.append(x)
            if bi < len(self.blocks) - 1:
                x = F.max_pool2d(x, 2)
        return stages


Params = Union[Dict, VGG16Features]


@functools.lru_cache(maxsize=4)
def _cached_module(weights_path: str, seed: int, device: torch.device) -> VGG16Features:
    return VGG16Features.from_params(get_params(weights_path, seed), device)


def vgg_module(weights_path: str = "", seed: int = 0, device="cpu") -> VGG16Features:
    """The tower of ``get_params(weights_path, seed)`` on ``device``, built
    once per ``(weights_path, seed, device)``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _cached_module(weights_path, seed, device)


def as_module(params: Params, device) -> VGG16Features:
    """``params`` as a module on ``device``: a dict is loaded there, a
    module must already be there."""
    device = torch.device(device)
    if not isinstance(params, VGG16Features):
        return VGG16Features.from_params(params, device)
    if params.device.type != device.type or device.index not in (None, params.device.index):
        raise ValueError(f"the VGG module is on {params.device}, the images on {device}")
    return params


def scale_input(images: torch.Tensor) -> torch.Tensor:
    """RGB [0, 255] -> [-1, 1] -> the LPIPS scaling layer, on the last axis."""
    x = images.to(torch.float32) / 127.5 - 1.0
    shift = torch.as_tensor(_LPIPS_SHIFT, device=x.device)
    scale = torch.as_tensor(_LPIPS_SCALE, device=x.device)
    return (x - shift) / scale


def vgg16_features(params: Params, image: torch.Tensor) -> List[torch.Tensor]:
    """Five LPIPS feature stages, each (C_s, H/2^s, W/2^s), of an (H, W, 3)
    RGB image in [0, 255]."""
    return [s[0] for s in vgg16_features_batched(params, image[None])]


def vgg16_features_batched(params: Params, images: torch.Tensor) -> List[torch.Tensor]:
    """Stages (N, C_s, h_s, w_s) of a batch of (N, h, w, 3) RGB [0, 255]
    images or windows, as one batched conv stack."""
    x = scale_input(images).permute(0, 3, 1, 2).contiguous()
    return vgg16_features_nchw(params, x)


@torch.inference_mode()
def vgg16_features_nchw(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """The conv/pool tower on pre-scaled (N, 3, H, W) input."""
    return as_module(params, x.device)(x)


def stage_lins(module: VGG16Features, widths=STAGE_CHANNELS) -> List[torch.Tensor]:
    """The module's LPIPS stage weights; without any, 1/C per channel for
    each stage width in ``widths``."""
    return module.lins or [torch.full((c,), 1.0 / c, dtype=torch.float32,
                                      device=module.device) for c in widths]


def normalize_features(feat: torch.Tensor, eps: float = 1e-10, dim: int = 0) -> torch.Tensor:
    """LPIPS unit normalisation over the channel axis ``dim``:
    ``f / (sqrt(sum f^2) + eps)``, eps outside the sqrt as in the JAX
    package; the sqrt correctly rounded on every device (``sqrt_rn``)."""
    norm = sqrt_rn(torch.sum(feat * feat, dim=dim, keepdim=True))
    return feat / (norm + eps)
