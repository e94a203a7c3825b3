"""2D / 3D drawing of one graph (port of ``utils/plot.py``): nodes coloured
by atom type, one line per edge, on matplotlib's Agg backend.  matplotlib
is imported only inside the functions."""

from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_2d(graph, lim: float = 1.0, ax=None, show: bool = False):
    """Nodes and edges of ``graph`` (a ``graph.Graph``) in the xy plane,
    each node annotated with its index; returns the axes."""
    plt = _pyplot()
    pos = np.asarray(graph.pos)
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4))
    for s, r in np.asarray(graph.edge_index).T:
        ax.plot(pos[[s, r], 0], pos[[s, r], 1], "k-", alpha=0.3)
    ax.scatter(pos[:, 0], pos[:, 1], c=np.asarray(graph.atoms), cmap="tab10",
               zorder=3)
    for i, p in enumerate(pos):
        ax.annotate(str(i), (p[0], p[1]))
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    if show:
        plt.show()
    return ax


def plot_3d(graph, lim: float = 1.0, ax=None, show: bool = False):
    """Nodes and edges of ``graph`` in 3D; returns the (3D) axes."""
    plt = _pyplot()
    pos = np.asarray(graph.pos)
    if ax is None:
        fig = plt.figure(figsize=(4, 4))
        ax = fig.add_subplot(projection="3d")
    for s, r in np.asarray(graph.edge_index).T:
        ax.plot(pos[[s, r], 0], pos[[s, r], 1], pos[[s, r], 2], "k-",
                alpha=0.3)
    ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2],
               c=np.asarray(graph.atoms), cmap="tab10")
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_zlim(-lim, lim)
    if show:
        plt.show()
    return ax
