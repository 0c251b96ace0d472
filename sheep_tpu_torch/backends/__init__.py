"""Subpackage of sheep_tpu_torch."""
