from cvcs_tpu_torch.models.registry import MODEL_REGISTRY, ModelSpec, build_model
from cvcs_tpu_torch.models.segformer import SegFormer
from cvcs_tpu_torch.models.swin import SwinUNet
from cvcs_tpu_torch.models.unet import UNet

__all__ = ["MODEL_REGISTRY", "ModelSpec", "SegFormer", "SwinUNet", "UNet",
           "build_model"]
