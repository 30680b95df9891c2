from storm_tpu_torch.infer.engine import InferenceEngine, shared_engine
from storm_tpu_torch.infer.operator import InferenceBolt

__all__ = ["InferenceBolt", "InferenceEngine", "shared_engine"]
