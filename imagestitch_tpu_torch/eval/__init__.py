"""Evaluation harnesses of imagestitch_tpu_torch that run on one device."""
