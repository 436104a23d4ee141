from mystereomatching_tpu_torch.models.presets import (
    MODEL_REGISTRY, build, get_model, list_models)

__all__ = ["MODEL_REGISTRY", "build", "get_model", "list_models"]
