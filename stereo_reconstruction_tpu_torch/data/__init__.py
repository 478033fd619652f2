from stereo_reconstruction_tpu_torch.data.records import StereoPair  # noqa: F401
from stereo_reconstruction_tpu_torch.data.middeval3 import MiddEval3  # noqa: F401
from stereo_reconstruction_tpu_torch.data.hitnet import (  # noqa: F401
    PrecomputedDisparities,
    average_disparity,
    read_grayscale_disparity,
    read_hitnet_disparity,
    rescale_to_gt_mean,
)
