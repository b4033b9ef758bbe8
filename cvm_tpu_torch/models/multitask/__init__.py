"""Counterpart of ``cvm_tpu.models.multitask``: one backbone with
detection, segmentation and depth heads, its processor and joint loss."""
