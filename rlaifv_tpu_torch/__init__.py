"""rlaifv_tpu_torch - the PyTorch / CUDA (NVIDIA Hopper) port of rlaifv_tpu.

The JAX package `rlaifv_tpu` is the reference; module names here mirror it
(`rlaifv_tpu_torch/models/llama.py` <-> `rlaifv_tpu/models/llama.py`). This
package imports torch and never jax, and nothing of `rlaifv_tpu`: it keeps
its own copies of the reference's jax-free modules (`constants`, `data/*`,
`utils/file_io`, `utils/prefetch`, the llava15 part of `train/family`, the
HF-checkpoint loaders of `models/convert`, `pairs/*` and `evals/*` with
their data files), function for function.

Subpackages
-----------
ops    : attention dispatch; hand-written sm_90a CUDA kernels (csrc/) for
         flash attention forward and backward (dq, dk/dv), prefix decode
         attention and the fused LM head (forward, dx, dW), each beside its
         plain PyTorch version
models : LLaVA-1.5 (CLIP ViT-L/14-336 + mlp2x_gelu projector + Llama,
         remat) and the bridge from the JAX package's param trees
genai  : eager decode engine (with shared-prefix pair scoring), sampling,
         beam search, diverse generation and autocheck
evals  : benchmark answers (`python -m rlaifv_tpu_torch.evals.vqa`, 3
         beams), the Object HalBench / MMHal / RefoMB judges and
         `python -m rlaifv_tpu_torch.evals.run_eval`
pipeline, iteration : the feedback-data pipeline and the iterative
         alignment driver (`python -m rlaifv_tpu_torch.iteration`)
train  : DPO math, the shared-prefix paired forward, the train step with
         an optax-exact AdamW, the reference-logp precompute, DPOTrainer
         and `python -m rlaifv_tpu_torch.train`
core   : the config tree (jax-free) and step checkpoints
utils  : synthetic preference pairs
data   : the numpy data layer: conversations, tokenisation, DPO collator,
         image preprocessor, parquet datasets
"""
