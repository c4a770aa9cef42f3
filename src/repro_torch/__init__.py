"""PyTorch/CUDA port of the MP-OTA-FL system.

The JAX package ``repro`` is the reference; this package mirrors its
subpackage layout (``core/``, ``kernels/``, ``retrieval/``, ``models/``,
``optim/``, ``launch/``, ``data/``, ``fl/``, ``obs/``, ``ckpt/``) and imports
neither JAX nor anything of ``repro``. Its kernels are CUDA C++ for
Hopper (``csrc/``), built at first use by ``kernels/_build.py``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
