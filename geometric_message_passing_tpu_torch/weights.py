"""Carry parameters of a JAX (flax) model over to its port.

The input is the flax variable tree with numpy (or array-like) leaves, e.g.
``jax.tree.map(np.asarray, variables)``; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def egnn_fused_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for ``models.egnn_fused.EGNNFusedModel`` from the
    variables of the JAX ``EGNNFusedModel``:
    ``params/emb_in/embedding [in, d]``, ``params/conv_i/<flat names>``,
    ``params/Dense_0``, ``params/Dense_1`` (or ``params/pred``); a flax
    ``kernel [in, out]`` becomes a ``torch.nn.Linear`` weight ``[out, in]``.
    ``load_state_dict(..., strict=True)`` accepts the result."""
    params = variables["params"]
    sd = {"emb_in.weight": _t(params["emb_in"]["embedding"])}
    n_layers = sum(1 for k in params if k.startswith("conv_"))
    for i in range(n_layers):
        for name, value in params[f"conv_{i}"].items():
            sd[f"convs.{i}.{name}"] = _t(value)
    for flax_name, torch_name in (("Dense_0", "dense_0"), ("Dense_1", "dense_1"),
                                  ("pred", "pred")):
        if flax_name in params:
            dense = params[flax_name]
            sd[f"{torch_name}.weight"] = _t(dense["kernel"]).T.contiguous()
            sd[f"{torch_name}.bias"] = _t(dense["bias"])
    return sd
