"""The parallel layer on ``torch.distributed`` (port of the JAX package's
``parallel/``): the rank mesh and its collectives, data parallelism and
ZeRO-1.  Tensor, pipeline and graph parallelism are not ported yet."""

from .data import dp_train_step, shard_batches  # noqa
from .launch import spawn  # noqa
from .mesh import (Mesh, collectives, init_distributed, make_hybrid_mesh,  # noqa
                   make_mesh, make_multihost_mesh)
from .zero import zero_dp_train_step, zero_init  # noqa
