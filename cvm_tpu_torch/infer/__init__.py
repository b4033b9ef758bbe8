"""Counterpart of ``cvm_tpu.infer``: serving postures and the batcher.

Unlike the reference's package, this one re-exports nothing, so importing a
submodule loads only what it needs."""
