"""The host-side numpy data layer of the port.

Copies of the JAX package's jax-free data modules (`conversation`,
`multimodal`, `preprocess`, `collator`, `diff_lib`, `image_processing`,
`datasets`), function for function, so both packages collate and
preprocess identically while the port imports nothing of `rlaifv_tpu`.
Scripts that drive the port take the pieces below from here.
"""
from rlaifv_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from rlaifv_tpu_torch.data.collator import DPOCollator
from rlaifv_tpu_torch.data.image_processing import ClipImageProcessor

__all__ = ["IGNORE_INDEX", "IMAGE_TOKEN_INDEX", "DPOCollator", "ClipImageProcessor"]
