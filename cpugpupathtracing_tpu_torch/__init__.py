"""PyTorch/CUDA port of the TPU wavefront path tracer for NVIDIA Hopper.

The JAX package `cpugpupathtracing_tpu` is the reference; this package
imports neither it nor JAX.  Entry points take a `device` that defaults
to the card; device="cpu" runs the plain PyTorch versions of the kernels.
"""

from cpugpupathtracing_tpu_torch.config import (
    BuildOption,
    DebugRenderMode,
    DiffusePdfMode,
    RenderMode,
    RenderSettings,
)

__version__ = "0.1.0"

__all__ = [
    "RenderSettings",
    "RenderMode",
    "DebugRenderMode",
    "BuildOption",
    "DiffusePdfMode",
    "__version__",
]
