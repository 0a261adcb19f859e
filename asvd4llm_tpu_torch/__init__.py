"""PyTorch/CUDA port of asvd4llm_tpu: activation-aware SVD compression of
causal LMs and greedy decode of the compressed model on an NVIDIA H100.

The JAX package ``asvd4llm_tpu`` is the reference; this package imports
neither it nor JAX. Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"``.
"""
