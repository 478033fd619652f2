"""Rectification: Loop-Zhang homographies, the warp onto a static canvas,
and epipolar lines (port of ``stereo_reconstruction_tpu/rectify``)."""

from stereo_reconstruction_tpu_torch.rectify.loop_zhang import (  # noqa: F401
    RectifyHomographies,
    loop_zhang_homographies,
)
from stereo_reconstruction_tpu_torch.rectify.rectifier import (  # noqa: F401
    RectifiedPair,
    disparity_to_original_frame,
    rectify_pair,
)
from stereo_reconstruction_tpu_torch.rectify.epilines import (  # noqa: F401
    draw_epilines,
    draw_rectified_epilines,
    epipolar_lines,
    epipole,
)
