"""VGG19 — one of the paper's own evaluation models (cost profile only)."""
import numpy as np

from repro_torch.core.jobs import InferenceJob
from repro_torch.costs.convnets import vgg19_profile


def config():
    return {"name": "vgg19", "kind": "convnet", "input": (224, 224, 3)}


def smoke_config():
    return config()


def cost_profile(*, batch: int = 1):
    return vgg19_profile(batch=batch)


def make_job(name: str, src: int, dst: int, *, batch: int = 1) -> InferenceJob:
    comp, data = vgg19_profile(batch=batch)
    return InferenceJob(name, src, dst, comp.astype(np.float32),
                        data.astype(np.float32))
