"""Faults planted under the timed path, for the checks that ``correct``
comes out false (``tests/test_portbench_harness.py`` on the CPU, and
``study.py``'s readings at the cells' own sizes on the card).

* ``frozen_state``: the optimizer's step returns the state unchanged;
* ``half_batch``: half of the frame's atoms left out of the pool and the
  sum over the rest doubled (the mean taken over the rest).

The cells run on one card, so no exchange between cards can be left out;
a training step produces no token or answer to alter.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def frozen_state():
    step = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = step


@contextlib.contextmanager
def half_batch():
    from geometric_message_passing_tpu_torch.models import pooling
    from geometric_message_passing_tpu_torch.ops.scatter import segment_sum
    saved = dict(pooling.POOL)

    def half_sum(x, batch):
        live = torch.nonzero(batch.node_mask).flatten()
        mask = batch.node_mask.clone()
        mask[live[live.shape[0] // 2:]] = False
        return 2.0 * segment_sum(x, batch.graph_id, batch.num_graphs, mask=mask)
    pooling.POOL.update(sum=half_sum, add=half_sum)
    try:
        yield
    finally:
        pooling.POOL.update(saved)


FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch}
