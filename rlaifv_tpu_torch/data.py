"""The host-side data pieces the port shares with the JAX package.

Token constants, the DPO collator and the CLIP image preprocessor are
numpy code with no jax import (`rlaifv_tpu.constants`,
`rlaifv_tpu.data.collator`, `rlaifv_tpu.data.image_processing`). The port
uses them as they are, so both packages collate and preprocess
identically; scripts that drive the port take them from here.
"""
from rlaifv_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from rlaifv_tpu.data.collator import DPOCollator
from rlaifv_tpu.data.image_processing import ClipImageProcessor

__all__ = ["IGNORE_INDEX", "IMAGE_TOKEN_INDEX", "DPOCollator", "ClipImageProcessor"]
