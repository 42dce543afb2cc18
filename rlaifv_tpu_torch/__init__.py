"""rlaifv_tpu_torch - the PyTorch / CUDA (NVIDIA Hopper) port of rlaifv_tpu.

The JAX package `rlaifv_tpu` is the reference; module names here mirror it
(`rlaifv_tpu_torch/models/llama.py` <-> `rlaifv_tpu/models/llama.py`). This
package imports torch and never jax. It reuses the jax-free modules of the
reference as they are: `rlaifv_tpu.constants`, `rlaifv_tpu.data.*` and
`rlaifv_tpu.utils.file_io`.

Subpackages
-----------
ops    : attention dispatch; hand-written sm_90a CUDA kernels (csrc/) for
         flash attention forward and prefix decode attention, each beside
         its plain PyTorch version
models : LLaVA-1.5 (CLIP ViT-L/14-336 + mlp2x_gelu projector + Llama)
         and the bridge from the JAX package's param trees
genai  : eager decode engine, sampling, diverse generation and autocheck
"""
