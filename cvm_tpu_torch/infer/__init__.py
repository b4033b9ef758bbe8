"""Counterpart of ``cvm_tpu.infer``: serving postures, int8 quantization,
the batcher, and the runtime and selftest of exported artifacts.

Unlike the reference's package, this one re-exports nothing, so importing a
submodule loads only what it needs."""
