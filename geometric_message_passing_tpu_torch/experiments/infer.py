"""Fixed-bucket batch inference (port of ``experiments/infer.py``, the
serving path).

``Predictor`` pads every batch to one bucket (nodes, edges, graphs), so
each call runs the same shapes:

    pred = Predictor(model, batch_size=100, device="cuda")
    y = pred.predict(graphs)          # [len(graphs), out_dim] np.ndarray

The bucket is sized from the first ``predict`` call (or pass ``pad=`` /
``triplet_pad=`` explicitly, e.g. the training loader's).  Larger graphs
later grow it once; ``trace_count`` counts the bucket sizings, the port's
analogue of the JAX package's recompiles.  The directional models take
``needs_triplets=True`` (DimeNet++) or ``with_quads=True`` (SphereNet): each
batch then carries its triplets (and quads), padded to a triplet bucket that
grows with the node bucket.  Multi-device serving (``mesh=``) is not ported
yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..graph import GraphLoader, pad_sizes
from ..triplets import triplet_pad_sizes


class Predictor:
    """Fixed-bucket inference over a model that maps a ``GraphBatch`` to
    ``[num_graphs, out_dim]``.  The model's parameters must be on
    ``device`` (default ``"cuda"``, which raises when CUDA is absent)."""

    def __init__(self, model: torch.nn.Module, batch_size: int = 100,
                 pad: Optional[tuple] = None, y_dtype=np.float32, device=None,
                 mesh=None, needs_triplets: bool = False,
                 with_quads: bool = False,
                 triplet_pad: Optional[tuple] = None):
        if mesh is not None:
            raise NotImplementedError("Predictor(mesh=) is not ported yet")
        self.needs_triplets = needs_triplets or with_quads
        self.with_quads = with_quads
        self.triplet_pad = triplet_pad
        self.device = resolve_device(device)
        for p in model.parameters():
            if p.device.type != self.device.type:
                raise ValueError(f"model parameter on {p.device}, "
                                 f"Predictor device is {self.device}")
        self.model = model
        self.batch_size = batch_size
        self.pad = pad
        self.y_dtype = y_dtype
        self.trace_count = 0      # number of distinct buckets served
        self._served_pad = None

    def _grow_bucket(self, graphs: Sequence) -> None:
        need = pad_sizes(graphs, self.batch_size)
        if self.pad is None:
            self.pad = need
        elif any(n > p for n, p in zip(need, self.pad)):
            self.pad = tuple(max(n, p) for n, p in zip(need, self.pad))
        if self.needs_triplets:
            need_t = triplet_pad_sizes(graphs, self.batch_size, self.with_quads)
            if self.triplet_pad is None:
                self.triplet_pad = need_t
            elif any(n > p for n, p in zip(need_t, self.triplet_pad)):
                self.triplet_pad = tuple(
                    max(n, p) for n, p in zip(need_t, self.triplet_pad))

    def predict(self, graphs: Sequence) -> np.ndarray:
        """Run the model over ``graphs``; returns [len(graphs), out_dim]."""
        if len(graphs) == 0:
            out_dim = getattr(self.model, "out_dim", None)
            if out_dim is None:
                raise ValueError(
                    "predict([]) needs the model to expose out_dim to shape "
                    "the empty result; call with at least one graph instead"
                )
            return np.zeros((0, out_dim), self.y_dtype)
        self._grow_bucket(graphs)
        bucket = (self.pad, self.triplet_pad)
        if bucket != self._served_pad:
            self.trace_count += 1
            self._served_pad = bucket
        loader = GraphLoader(graphs, self.batch_size, shuffle=False,
                             y_dtype=self.y_dtype, pad=self.pad,
                             with_triplets=self.needs_triplets,
                             with_quads=self.with_quads,
                             triplet_pad=self.triplet_pad)
        outs, remaining = [], len(graphs)
        was_training = self.model.training
        self.model.eval()               # the JAX package's train=False
        try:
            with torch.inference_mode():
                for batch in loader:
                    n_real = min(self.batch_size, remaining)
                    remaining -= n_real
                    outs.append(self.model(batch.to(self.device))[:n_real])
                return torch.cat(outs, dim=0).cpu().numpy()
        finally:
            self.model.train(was_training)

    __call__ = predict
