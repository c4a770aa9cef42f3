"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``ota_fused`` (packed OTA superpose/fold, in-pass quantize and
superpose), ``topk_similarity`` (batched cosine top-k),
``flash_attention`` (flash attention, causal or not, Sq != Sk),
``quantize`` (per-tensor fake-quant), ``ota_aggregate`` (weighted
superpose plus noise) and ``qmatmul`` (weight-only int8 matrix product).
``ops`` holds the entry points with the reference's names; this package
exports the six that the JAX package's ``repro.kernels`` exports and the
reference's other ``ops`` entry names (the packed superpose and fold, the
cosine top-k and the row-major int4 pack). ``_build`` compiles
``csrc/*.cu`` with nvcc at first use and loads them with ctypes.

As in the reference, the exported functions ``ota_aggregate`` and
``qmatmul`` hide the submodules of the same names as attributes of this
package; ``from repro_torch.kernels.qmatmul import ...`` reaches the module.
"""

from repro_torch.kernels.ops import (  # noqa: F401
    fake_quant,
    flash_mha,
    ota_aggregate,
    ota_dequant_superpose,
    ota_fold_packed,
    ota_quantize_superpose,
    pack_int4_rows,
    qmatmul,
    quantize_weights,
    topk_cosine,
    unpack_int4_rows,
)
