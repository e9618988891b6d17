from .synthetic import (
    VLM_PATCHES,
    VLM_PATCHES_REDUCED,
    PipelineSpec,
    global_batch,
    make_batch,
)

__all__ = ["PipelineSpec", "VLM_PATCHES", "VLM_PATCHES_REDUCED",
           "global_batch", "make_batch"]
