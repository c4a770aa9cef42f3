"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and resolves it here to the CUDA
card. Without a visible card that raises: the port never carries on on
the CPU by itself. The CPU runs only when a caller asks for it, as the
parity tests do with ``device="cpu"``.

This module also sets the float32 precision of the card's math libraries,
once, at import of the package: TF32 off for cuBLAS matrix products and
for cuDNN convolutions. cuDNN runs a float32 convolution (the DeepSpeech2
frontend) in TF32 by default, which keeps about three decimal digits;
the reference computes it in full float32.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raises when no card is
    visible. An explicit device is returned as given (a CUDA device
    still needs a card)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is visible")
    return dev
