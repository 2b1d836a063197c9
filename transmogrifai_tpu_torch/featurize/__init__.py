"""The quantized serving plane of the fused scoring graph."""
