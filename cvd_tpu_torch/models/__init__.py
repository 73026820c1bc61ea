from cvd_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from cvd_tpu_torch.models.epi import EpiConditioning
