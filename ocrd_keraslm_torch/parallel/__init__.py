"""Training and serving over several ranks: ``torch.distributed``
meshes, sharded steps and sharded batches.

Counterpart of ``ocrd_keraslm_tpu/parallel/``: data parallelism over
the batch and carry, tensor parallelism over the vocabulary of the tied
char embedding (``train.py``), pipeline stages over the layer stack
(``pipeline.py``), and the serving side, scoring (``score.py``), batch
decoding (``decode.py``) and generation (``generate.py``) split over
the ``data`` axis.  One process per rank (``multihost.py``), the
collectives explicit (``comm.py``), every rank's kernels the port's own.
"""
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, gather_params, make_mesh,
                   shard_batch, shard_carry, shard_params)
from .train import make_sharded_eval_step, make_sharded_train_step

__all__ = ['DATA_AXIS', 'MODEL_AXIS', 'Mesh', 'gather_params', 'make_mesh',
           'shard_batch', 'shard_carry', 'shard_params',
           'make_sharded_eval_step', 'make_sharded_train_step']
