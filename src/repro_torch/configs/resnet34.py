"""ResNet34 — one of the paper's own evaluation models (cost profile only)."""
import numpy as np

from repro_torch.core.jobs import InferenceJob
from repro_torch.costs.convnets import resnet34_profile


def config():
    return {"name": "resnet34", "kind": "convnet", "input": (224, 224, 3)}


def smoke_config():
    return config()


def cost_profile(*, batch: int = 1):
    return resnet34_profile(batch=batch)


def make_job(name: str, src: int, dst: int, *, batch: int = 1) -> InferenceJob:
    comp, data = resnet34_profile(batch=batch)
    return InferenceJob(name, src, dst, comp.astype(np.float32),
                        data.astype(np.float32))
