"""Counterpart of ``cvm_tpu.data``: synthetic scenes (serving planes and a
resumable training stream) and host -> device batch prefetch."""
