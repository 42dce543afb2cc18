"""rlaifv_tpu_torch - the PyTorch / CUDA (NVIDIA Hopper) port of rlaifv_tpu.

The JAX package `rlaifv_tpu` is the reference; module names here mirror it
(`rlaifv_tpu_torch/models/llama.py` <-> `rlaifv_tpu/models/llama.py`). This
package imports torch and never jax. It reuses the jax-free modules of the
reference as they are: `rlaifv_tpu.constants`, `rlaifv_tpu.data.*`,
`rlaifv_tpu.utils.file_io`, `rlaifv_tpu.utils.prefetch`,
`rlaifv_tpu.train.family` and the numpy checkpoint converter
`rlaifv_tpu.models.convert`.

Subpackages
-----------
ops    : attention dispatch; hand-written sm_90a CUDA kernels (csrc/) for
         flash attention forward and backward (dq, dk/dv) and prefix
         decode attention, each beside its plain PyTorch version
models : LLaVA-1.5 (CLIP ViT-L/14-336 + mlp2x_gelu projector + Llama,
         remat) and the bridge from the JAX package's param trees
genai  : eager decode engine, sampling, diverse generation and autocheck
train  : DPO math, the shared-prefix paired forward, the train step with
         an optax-exact AdamW, DPOTrainer and `python -m
         rlaifv_tpu_torch.train`
core   : the config tree (jax-free) and step checkpoints
utils  : synthetic preference pairs
data   : the shared numpy constants, DPO collator and image preprocessor
"""
