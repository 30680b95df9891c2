from storm_tpu_torch.models.registry import ModelDef, build_model, model_def, registry_names

__all__ = ["ModelDef", "build_model", "model_def", "registry_names"]
