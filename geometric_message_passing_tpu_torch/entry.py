"""The port's counterpart of the repository's ``__graft_entry__.py::entry``:
one forward of the flagship model, MACE, on a tiny batch.

    from geometric_message_passing_tpu_torch.entry import entry
    fn, args = entry()                 # on the card; entry(device="cpu")
    out = fn(*args)                    # [5, 1]: 4 graphs and the pad graph

``MACEModel(num_layers=2, emb_dim=16, max_ell=2, correlation=2,
mlp_dim=64, in_dim=1, out_dim=1)``, its weights drawn from seed 0 and in
eval mode (the batch norm reads its running statistics, as the JAX
``model.apply`` does), over 4 star graphs on folds 4 and 5 (seed 0) in one
padded batch.  On the card the forward runs K7 and K4 twice each.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from . import resolve_device
from .datasets import create_star_graphs
from .graph import GraphBatch, GraphLoader
from .models import MACEModel

ENTRY_MODEL = dict(num_layers=2, emb_dim=16, max_ell=2, correlation=2,
                   mlp_dim=64, in_dim=1, out_dim=1)


def tiny_batch(batch_size: int = 4, fold=(4, 5)) -> GraphBatch:
    """``batch_size`` star graphs on ``fold`` (seed 0) as one padded batch
    on the host."""
    graphs = create_star_graphs(num=batch_size, fold=list(fold), dim=3, seed=0)
    return next(iter(GraphLoader(graphs, batch_size=batch_size)))


def forward(model: torch.nn.Module, batch: GraphBatch) -> torch.Tensor:
    return model(batch)


def entry(device=None) -> Tuple[Callable, tuple]:
    """``(fn, (model, batch))``: ``fn(model, batch)`` is the forward, on
    ``device`` (default ``"cuda"``, which raises when CUDA is absent)."""
    dev = resolve_device(device)
    model = MACEModel(**ENTRY_MODEL, generator=torch.Generator().manual_seed(0),
                      device=dev).eval()
    return forward, (model, tiny_batch().to(dev))
