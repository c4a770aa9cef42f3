"""Model zoo of the port (DeepSpeech2 and the dense LMs so far)."""

from repro_torch.models.registry import Model, build_model

__all__ = ["Model", "build_model"]
