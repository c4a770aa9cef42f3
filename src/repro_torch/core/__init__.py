"""Data plane of the port: packing, quantization, the wire codec and
packed OTA aggregation."""

from repro_torch.core import channel, ota, quant, wire  # noqa: F401
