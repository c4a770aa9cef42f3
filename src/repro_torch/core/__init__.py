"""Data plane of the port: packing, quantization, the wire codec and
packed OTA aggregation."""
