"""Sweep planning shared by the families' batched fits."""
