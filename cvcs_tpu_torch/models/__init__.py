from cvcs_tpu_torch.models.registry import MODEL_REGISTRY, ModelSpec, build_model
from cvcs_tpu_torch.models.swin import SwinUNet

__all__ = ["MODEL_REGISTRY", "ModelSpec", "SwinUNet", "build_model"]
