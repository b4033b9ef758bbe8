"""Counterpart of ``cvm_tpu.models.dmds``: two-frame unsupervised depth and
motion (DMDS, config E): the depth net, the ego/object motion net, the
photometric loss and the two-frame processor."""
