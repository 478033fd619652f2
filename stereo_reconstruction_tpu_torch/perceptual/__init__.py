"""The perceptual (VGG-16 / LPIPS) matcher, BASELINE config 3: port of
``stereo_reconstruction_tpu/perceptual``. ``pipeline.compute_disparity``
reaches it with ``MatcherConfig.cost == "perceptual"``."""

from stereo_reconstruction_tpu_torch.perceptual.vgg import (  # noqa: F401
    VGG16Features,
    get_params,
    init_vgg16_params,
    load_params_npz,
    save_params_npz,
    vgg16_features,
    vgg_module,
)
from stereo_reconstruction_tpu_torch.perceptual.cost import (  # noqa: F401
    lpips_cost_volume,
    perceptual_window_search,
    windowed_lpips_cost_volume,
    windowed_lpips_search,
    windowed_smooth_argmin,
)
from stereo_reconstruction_tpu_torch.perceptual.notebook_oracle import (  # noqa: F401
    notebook_rows,
    notebook_window_search,
)
