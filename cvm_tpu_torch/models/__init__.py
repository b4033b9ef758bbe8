"""Counterpart of ``cvm_tpu.models``: layers, backbones and CenterNet."""
