"""The multi-device layer: meshes, the sharded matcher and metrics, and
the distributed bundle adjustments (port of
``stereo_reconstruction_tpu/parallel``)."""

from stereo_reconstruction_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from stereo_reconstruction_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_block_search_right,
    sharded_evaldisp,
)
from stereo_reconstruction_tpu_torch.parallel.ba_dist import (  # noqa: F401
    distributed_bundle_adjust,
    distributed_bundle_adjust_batch,
)
