"""Counterpart of ``cvm_tpu.parallel``: multi-process training and serving
over ``torch.distributed`` (``mesh.py``: the process group, the (data,
model) grid and the serving batch's rows; ``reduce.py``: the all-reduces
of the global batch's losses and BatchNorm statistics; ``sharding.py``:
tensor parallelism on the stage-5 blocks; ``spatial.py``: H-sharded 3x3
convs with halo exchange)."""
