"""Counterpart of ``cvm_tpu.models.semseg``: the encoder-decoder
segmentation model, its processor and loss."""
