"""Counterpart of ``cvm_tpu.train``: optimizer, training loop (with the stall
watchdog), checkpoints, metrics and TensorBoard, evaluation,
quantization-aware training and the LR finder, for every ported model (the
mesh is not ported: ROADMAP Queue 1 item 17)."""
