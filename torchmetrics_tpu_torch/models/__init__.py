"""Feature networks of the model-based image metrics (FID-InceptionV3 and
the LPIPS trunks) as ``nn.Module``s, with their weight carrying.
Counterpart of ``torchmetrics_tpu/models/``."""
from .inception import FIDInceptionV3, convert_torch_state_dict, make_fid_inception
from .lpips import LPIPSNet, convert_lpips_torch, lpips_head_params, make_lpips

__all__ = [
    "FIDInceptionV3",
    "LPIPSNet",
    "convert_lpips_torch",
    "convert_torch_state_dict",
    "lpips_head_params",
    "make_fid_inception",
    "make_lpips",
]
