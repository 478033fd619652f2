from stereo_reconstruction_tpu_torch.recon.disparity import (  # noqa: F401
    remove_disparity_outliers,
    scale_disparity,
    disparity_to_depth,
)
from stereo_reconstruction_tpu_torch.recon.backproject import backproject  # noqa: F401
from stereo_reconstruction_tpu_torch.recon.meshing import grid_mesh, save_mesh  # noqa: F401
from stereo_reconstruction_tpu_torch.recon.simple_mesh import (  # noqa: F401
    SimpleMesh,
    show_extrinsics,
)
