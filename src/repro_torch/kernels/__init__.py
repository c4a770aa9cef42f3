"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``ota_fused`` (packed OTA superpose/fold, in-pass quantize and
superpose), ``topk_similarity`` (batched cosine top-k) and
``flash_attention`` (causal flash attention of prefill). ``_build``
compiles ``csrc/*.cu`` with nvcc at first use and loads them with
ctypes."""
