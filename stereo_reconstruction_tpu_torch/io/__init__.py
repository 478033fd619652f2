from stereo_reconstruction_tpu_torch.io.pfm import read_pfm, write_pfm  # noqa: F401
from stereo_reconstruction_tpu_torch.io.calib import parse_calib, Calibration  # noqa: F401
from stereo_reconstruction_tpu_torch.io.image import read_image, write_image  # noqa: F401
from stereo_reconstruction_tpu_torch.io.mesh_io import write_off  # noqa: F401
