"""Counterpart of ``cvm_tpu.train``: optimizer, training loop (with the stall
watchdog), checkpoints, metrics and TensorBoard, evaluation,
quantization-aware training and the LR finder, for every ported model, on
one process or as one rank of a multi-process run (``parallel/``)."""
