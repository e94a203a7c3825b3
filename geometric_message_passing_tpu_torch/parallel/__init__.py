"""The parallel layer on ``torch.distributed`` (port of the JAX package's
``parallel/``): the rank mesh and its collectives (``differentiable``: the
ones a model's forward runs), data parallelism (the explicit step and the
autoshard one), ZeRO-1, tensor parallelism over MACE's and TFN's
channels, the GPipe pipeline and graph partitioning (the halo exchange
over a Morton-partitioned graph)."""

from .data import (autoshard_rows, dp_train_step,  # noqa
                   dp_train_step_autoshard, shard_batches)
from .halo import (HaloPlan, build_halo_plan, gp_edge_aggregate,  # noqa
                   gp_egnn_layer, gp_gather_nodes, gp_local_batch,
                   gp_rank_batch, gp_scatter_nodes, halo_catalog, halo_stats,
                   packed_halo_aggregate, packed_halo_aggregate_overlapped)
from .launch import spawn  # noqa
from .mesh import (Mesh, collectives, differentiable,  # noqa
                   init_distributed, make_hybrid_mesh, make_mesh,
                   make_multihost_mesh, solo_mesh)
from .partition import (morton_key, morton_partition_graph,  # noqa
                        morton_permutation, partition_stats,
                        permute_graph_nodes)
from .pp import (egnn_pipeline_stage, pipeline_apply,  # noqa
                 sequential_apply, stack_stage_params)
from .tp import (dp_tp_train_step, shard_mace_variables,  # noqa
                 shard_model_variables, tp_apply, tp_local_model,
                 tp_train_step)
from .zero import zero_dp_train_step, zero_init  # noqa
