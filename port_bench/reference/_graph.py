"""The references' own graphs, built on the device from the positions:
every ordered pair (s, r), s != r, with squared float64 distance at most
cutoff^2 (all pairs in row blocks), and DimeNet++'s triplets k -> j -> i
(for each edge j -> i every edge k -> j with k != i)."""

from __future__ import annotations

import torch


def radius_graph(pos: torch.Tensor, cutoff: float, block: int = 1024):
    """``(senders, receivers)`` int64, ordered by sender then receiver."""
    p = pos.double()
    n = p.shape[0]
    ss, rr = [], []
    for a in range(0, n, block):
        q = p[a:a + block]
        d2 = ((q[:, None, 0] - p[None, :, 0]) ** 2
              + (q[:, None, 1] - p[None, :, 1]) ** 2
              + (q[:, None, 2] - p[None, :, 2]) ** 2)
        i, j = torch.nonzero(d2 <= cutoff * cutoff, as_tuple=True)
        i = i + a
        keep = i != j
        ss.append(i[keep])
        rr.append(j[keep])
    return torch.cat(ss), torch.cat(rr)


def triplets(senders: torch.Tensor, receivers: torch.Tensor, n: int):
    """``(idx_i, idx_j, idx_k, idx_kj, idx_ji)`` of every triplet: edge
    ``idx_ji`` is j -> i, edge ``idx_kj`` is k -> j, k != i."""
    E = senders.shape[0]
    order = torch.argsort(receivers, stable=True)
    indeg = torch.bincount(receivers, minlength=n)
    rowptr = torch.zeros(n + 1, dtype=torch.long, device=senders.device)
    rowptr[1:] = torch.cumsum(indeg, 0)
    cnt = indeg[senders]
    e = torch.repeat_interleave(torch.arange(E, device=senders.device), cnt)
    start = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    within = torch.arange(e.shape[0], device=senders.device) - start
    e2 = order[rowptr[senders[e]] + within]
    keep = senders[e2] != receivers[e]
    e, e2 = e[keep], e2[keep]
    return receivers[e], senders[e], senders[e2], e2, e
