from stereo_reconstruction_tpu_torch.pose.eight_point import (  # noqa: F401
    EightPointResult,
    eight_point,
)
from stereo_reconstruction_tpu_torch.pose.ransac import ransac_eight_point  # noqa: F401
from stereo_reconstruction_tpu_torch.pose.ba import bundle_adjust, BAResult  # noqa: F401
from stereo_reconstruction_tpu_torch.pose.pipeline import (  # noqa: F401
    BA_ROUNDS,
    PoseEstimate,
    estimate_pose_from_matches,
    settle_pose,
)
