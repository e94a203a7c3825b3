"""The parallel layer on ``torch.distributed`` (port of the JAX package's
``parallel/``): the rank mesh and its collectives (``differentiable``: the
ones a model's forward runs), data parallelism, ZeRO-1, tensor parallelism
over MACE's and TFN's channels and the GPipe pipeline.  Graph partitioning
is not ported yet."""

from .data import dp_train_step, shard_batches  # noqa
from .launch import spawn  # noqa
from .mesh import (Mesh, collectives, differentiable,  # noqa
                   init_distributed, make_hybrid_mesh, make_mesh,
                   make_multihost_mesh)
from .pp import (egnn_pipeline_stage, pipeline_apply,  # noqa
                 sequential_apply, stack_stage_params)
from .tp import (dp_tp_train_step, shard_mace_variables,  # noqa
                 shard_model_variables, tp_apply, tp_local_model,
                 tp_train_step)
from .zero import zero_dp_train_step, zero_init  # noqa
