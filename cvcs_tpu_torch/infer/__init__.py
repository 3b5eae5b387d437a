from cvcs_tpu_torch.infer.engine import InferenceConfig, SceneSegmenter

__all__ = ["InferenceConfig", "SceneSegmenter"]
