"""The references' training steps: the loss ``|E - y|``, backward, and a
plain Adam step (the measured program's constants: lr 1e-4, betas 0.9 /
0.999, eps 1e-8 added to the bias-corrected root), written out."""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

BETAS, EPS = (0.9, 0.999), 1e-8


def train_steps(model: torch.nn.Module, energy: Callable[[], torch.Tensor],
                y: float, steps: int, lr: float) -> dict:
    """``steps`` steps from the model's weights, ``energy`` giving the
    atoms' energies ``[N]``: each step's energy (their sum), its scale
    (the sum of their absolute values, which cannot cancel as the energy
    can) and loss, each leaf's gradient norm at step 1, each leaf's change
    after the last step and its path (the sum of its steps' norms, which
    cannot cancel as the change can when a gradient turns round between
    steps; norms in float64)."""
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    energies, scales, losses, grad = [], [], [], {}
    path = dict.fromkeys(params, 0.0)
    for t in range(1, steps + 1):
        for p in params.values():
            p.grad = None
        atoms = energy()
        e = atoms.sum()
        loss = (e - y).abs()
        loss.backward()
        energies.append(float(e.detach()))
        scales.append(float(atoms.detach().abs().sum()))
        losses.append(float(loss.detach()))
        if t == 1:
            grad = {k: _norm(p.grad) for k, p in params.items()}
        b1, b2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
        with torch.no_grad():
            for k, p in params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (v[k].sqrt() / math.sqrt(b2)).add_(EPS)
                p.addcdiv_(m[k], denom, value=-lr / b1)
                path[k] += lr / b1 * _norm(m[k] / denom)
    delta = {k: _norm(p.detach() - start[k]) for k, p in params.items()}
    return {"energies": energies, "scales": scales, "losses": losses,
            "grad": grad, "delta": delta, "path": path}


def _norm(t) -> float:
    return 0.0 if t is None else float(torch.linalg.vector_norm(t.double()))


def load(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s parameters; the names and shapes
    must match exactly."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights and model differ: only in the model "
                         f"{sorted(set(params) - set(weights))[:5]}, only in "
                         f"the weights {sorted(set(weights) - set(params))[:5]}")
    with torch.no_grad():
        for k, p in params.items():
            if p.shape != weights[k].shape:
                raise ValueError(f"{k}: shape {tuple(p.shape)} against "
                                 f"{tuple(weights[k].shape)}")
            p.copy_(weights[k])
