# A copy of rlaifv_tpu/constants.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Model-level constants shared across the framework.

Values match the reference so artifacts (tokenized data, parquet caches)
interoperate (ref: llava/constants.py:7-13, muffin/train/train_utils.py:20-25).
"""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"

# OpenAI-CLIP normalization statistics (used by CLIP-L/14-336 and EVA02).
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
