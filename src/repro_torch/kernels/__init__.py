"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``ota_fused`` (packed OTA superpose/fold) and
``topk_similarity`` (batched cosine top-k). ``_build`` compiles
``csrc/*.cu`` with nvcc at first use and loads them with ctypes."""
