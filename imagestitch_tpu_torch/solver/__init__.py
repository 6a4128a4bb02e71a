"""Subpackage of imagestitch_tpu_torch."""
