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


def _dense(sd: Dict[str, torch.Tensor], prefix: str,
           dense: Mapping[str, Any]) -> None:
    """A flax Dense (``kernel [in, out]``, optional ``bias``) as the
    ``torch.nn.Linear`` at ``prefix`` (``weight [out, in]``)."""
    sd[f"{prefix}.weight"] = _t(dense["kernel"]).T.contiguous()
    if "bias" in dense:
        sd[f"{prefix}.bias"] = _t(dense["bias"])


def _batch_norm(sd: Dict[str, torch.Tensor], prefix: str,
                tree: Mapping[str, Any], stats) -> None:
    """A flax ``BatchNorm`` (``scale``, ``bias``; ``batch_stats`` ``mean``,
    ``var``) as the port's ``nn.basic.BatchNorm`` at ``prefix``."""
    if stats is None:
        raise ValueError(f"no batch_stats for {prefix}")
    sd[f"{prefix}.weight"] = _t(tree["scale"])
    sd[f"{prefix}.bias"] = _t(tree["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])


def _mlp(sd: Dict[str, torch.Tensor], prefix: str,
         mlp: Mapping[str, Any], stats=None) -> None:
    """A JAX ``MLP``'s ``Dense_k`` / ``LayerNorm_k`` / ``BatchNorm_k`` as
    the port's ``MLP.dense[k]`` / ``MLP.norm[k]``; a ``BatchNorm_k``'s
    running statistics come from ``stats``, the MLP's ``batch_stats``
    subtree."""
    for name, value in mlp.items():
        kind, k = name.rsplit("_", 1)
        if kind == "Dense":
            _dense(sd, f"{prefix}.dense.{k}", value)
        elif kind == "LayerNorm":
            sd[f"{prefix}.norm.{k}.weight"] = _t(value["scale"])
            sd[f"{prefix}.norm.{k}.bias"] = _t(value["bias"])
        elif kind == "BatchNorm":
            _batch_norm(sd, f"{prefix}.norm.{k}", value,
                        (stats or {}).get(name))
        else:
            raise ValueError(f"unexpected MLP entry {prefix}/{name}")


def egnn_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for ``models.egnn.EGNNModel`` from the variables of the
    JAX ``EGNNModel``: ``params/emb_in/embedding``,
    ``params/conv_i/{mlp_msg,mlp_pos,mlp_upd}/{Dense_k,LayerNorm_k}`` (or
    ``BatchNorm_k`` with its ``batch_stats``) and ``params/Dense_0``,
    ``params/Dense_1`` (or ``params/pred``)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {"emb_in.weight": _t(params["emb_in"]["embedding"])}
    n_layers = sum(1 for k in params if k.startswith("conv_"))
    for i in range(n_layers):
        for mlp in ("mlp_msg", "mlp_pos", "mlp_upd"):
            _mlp(sd, f"convs.{i}.{mlp}", params[f"conv_{i}"][mlp],
                 stats.get(f"conv_{i}", {}).get(mlp))
    for flax_name, torch_name in (("Dense_0", "dense_0"), ("Dense_1", "dense_1"),
                                  ("pred", "pred")):
        if flax_name in params:
            _dense(sd, torch_name, params[flax_name])
    return sd


def egnn_layer_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The parameters of a JAX ``EGNNLayer`` (``mlp_msg``, ``mlp_pos``,
    ``mlp_upd``, layer or no norm) under ``models.egnn.EGNNLayer``'s
    names: one pipeline stage's dict (``parallel.pp``)."""
    sd: Dict[str, torch.Tensor] = {}
    for mlp in ("mlp_msg", "mlp_pos", "mlp_upd"):
        _mlp(sd, mlp, params[mlp])
    return sd


def egnn_stages_from_jax(stacked: Mapping[str, Any]
                         ) -> list:
    """The JAX ``stack_stage_params`` tree of ``EGNNLayer`` parameters
    (every leaf with a leading stage axis) as one ``egnn_layer_from_jax``
    dict a stage."""
    def stage(tree, s):
        return {k: stage(v, s) if isinstance(v, Mapping) else np.asarray(v)[s]
                for k, v in tree.items()}

    n = len(np.asarray(stacked["mlp_msg"]["Dense_0"]["kernel"]))
    return [egnn_layer_from_jax(stage(stacked, s)) for s in range(n)]


def mpnn_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for ``models.egnn.MPNNModel`` from the variables of the
    JAX ``MPNNModel``: ``params/emb_in/embedding``,
    ``params/conv_i/{mlp_msg,mlp_upd}/{Dense_k,LayerNorm_k}`` (or
    ``BatchNorm_k`` with its ``batch_stats``) and ``params/Dense_0``,
    ``params/Dense_1``."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {"emb_in.weight": _t(params["emb_in"]["embedding"])}
    n_layers = sum(1 for k in params if k.startswith("conv_"))
    for i in range(n_layers):
        for mlp in ("mlp_msg", "mlp_upd"):
            _mlp(sd, f"convs.{i}.{mlp}", params[f"conv_{i}"][mlp],
                 stats.get(f"conv_{i}", {}).get(mlp))
    for k in range(2):
        _dense(sd, f"dense_{k}", params[f"Dense_{k}"])
    return sd


_GNN101_LAYERS = ("MPNN101Layer", "InvariantMPNNLayer", "EquivariantMPNNLayer")


def _gnn101_tree(sd: Dict[str, torch.Tensor], prefix: str,
                 params: Mapping[str, Any], stats: Mapping[str, Any]) -> None:
    for name, value in params.items():
        kind, k = name.rsplit("_", 1)
        if kind == "Dense":
            _dense(sd, f"{prefix}dense_{k}", value)
        elif kind == "_BNMLP":
            _mlp(sd, f"{prefix}bnmlp_{k}", value, stats.get(name))
        elif kind in _GNN101_LAYERS:
            _gnn101_tree(sd, f"{prefix}layers.{k}.", value, stats.get(name, {}))
        else:
            raise ValueError(f"unexpected gnn101 entry {prefix}{name}")


def gnn101_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for a model or layer of ``models.gnn101`` from the
    variables of its JAX twin (``params`` and ``batch_stats``): ``Dense_k``
    -> ``dense_k``, ``_BNMLP_k/{Dense_j, BatchNorm_j}`` -> ``bnmlp_k.dense.j``
    / ``bnmlp_k.norm.j`` (running statistics from ``batch_stats``), and
    ``MPNN101Layer_k`` / ``InvariantMPNNLayer_k`` /
    ``EquivariantMPNNLayer_k`` -> ``layers.k``.  The notebook's first
    model, the JAX ``MPNNModel`` (``params/emb_in``), goes to
    ``mpnn_from_jax``."""
    params = variables["params"]
    if "emb_in" in params:
        return mpnn_from_jax(variables)
    sd: Dict[str, torch.Tensor] = {}
    _gnn101_tree(sd, "", params, variables.get("batch_stats", {}))
    return sd


def schnet_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for ``models.schnet.SchNetModel`` from the variables of the
    JAX ``SchNetModel``: ``params/embedding/embedding [100, d]``,
    ``params/interaction_i/Dense_0..Dense_4`` (``Dense_2`` without bias) and
    ``params/Dense_0``, ``params/Dense_1``."""
    params = variables["params"]
    sd = {"embedding.weight": _t(params["embedding"]["embedding"])}
    n_layers = sum(1 for k in params if k.startswith("interaction_"))
    for i in range(n_layers):
        for k in range(5):
            _dense(sd, f"interactions.{i}.dense_{k}",
                   params[f"interaction_{i}"][f"Dense_{k}"])
    for k in range(2):
        _dense(sd, f"dense_{k}", params[f"Dense_{k}"])
    return sd


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
            _dense(sd, torch_name, params[flax_name])
    return sd


def _gvp(sd: Dict[str, torch.Tensor], prefix: str,
         tree: Mapping[str, Any]) -> None:
    """A JAX ``nn.gvp.GVP`` (``wh``, ``ws``, ``wv``, ``wsv`` Denses) as the
    port's ``GVP`` at ``prefix``."""
    for name, dense in tree.items():
        if name not in ("wh", "ws", "wv", "wsv"):
            raise ValueError(f"unexpected GVP entry {prefix}/{name}")
        _dense(sd, f"{prefix}.{name}", dense)


def _layer_norm(sd: Dict[str, torch.Tensor], prefix: str,
                tree: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(tree["scale"])
    sd[f"{prefix}.bias"] = _t(tree["bias"])


def gvp_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for ``models.gvpgnn.GVPGNNModel`` from the variables of
    the JAX ``GVPGNNModel``: ``params/emb_in/embedding``, ``LayerNorm_0``,
    the GVPs ``W_v`` and ``W_e``, ``W_e_norm/LayerNorm_0``,
    ``layer_i/{conv, norm0, norm1, ff_k}`` (the conv's flat
    ``gvp{k}_{wh,wv,ws,bs,wsv,bsv}`` arrays, or its ``gvp_k`` GVPs on the
    general-config route) and ``Dense_0``/``Dense_1`` or ``pred``.
    ``load_state_dict(..., strict=True)`` accepts the result."""
    params = variables["params"]
    sd = {"emb_in.weight": _t(params["emb_in"]["embedding"])}
    _layer_norm(sd, "layer_norm_0", params["LayerNorm_0"])
    _gvp(sd, "W_v", params["W_v"])
    _gvp(sd, "W_e", params["W_e"])
    _layer_norm(sd, "W_e_norm.layer_norm", params["W_e_norm"]["LayerNorm_0"])
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    for i in range(n_layers):
        for name, value in params[f"layer_{i}"].items():
            prefix = f"layers.{i}"
            if name == "conv":
                for key, leaf in value.items():
                    if key.startswith("gvp_"):
                        _gvp(sd, f"{prefix}.conv.gvps.{key[4:]}", leaf)
                    else:
                        sd[f"{prefix}.conv.{key}"] = _t(leaf)
            elif name in ("norm0", "norm1"):
                _layer_norm(sd, f"{prefix}.{name}.layer_norm",
                            value["LayerNorm_0"])
            elif name.startswith("ff_"):
                _gvp(sd, f"{prefix}.ff.{name[3:]}", value)
            else:
                raise ValueError(f"unexpected entry layer_{i}/{name}")
    for flax_name, torch_name in (("Dense_0", "dense_0"), ("Dense_1", "dense_1"),
                                  ("pred", "pred")):
        if flax_name in params:
            _dense(sd, torch_name, params[flax_name])
    return sd


def _tp_conv(sd: Dict[str, torch.Tensor], prefix: str,
             conv: Mapping[str, Any], stats: Mapping[str, Any]) -> None:
    """A JAX ``TensorProductConvLayer`` (``fc``, ``fc_out{g}``, ``_bn`` and
    its ``batch_stats``) as the port's at ``prefix``."""
    for name, value in conv.items():
        if name == "fc":
            _mlp(sd, f"{prefix}.fc", value)
        elif name.startswith("fc_out"):
            _dense(sd, f"{prefix}.fc_out.{name[len('fc_out'):]}", value)
        elif name == "_bn":
            for key, leaf in value.items():
                sd[f"{prefix}.bn.{key}"] = _t(leaf)
        else:
            raise ValueError(f"unexpected entry {prefix}/{name}")
    for key, leaf in stats.get("_bn", {}).items():
        sd[f"{prefix}.bn.{key}"] = _t(leaf)


def _readout(sd: Dict[str, torch.Tensor], params: Mapping[str, Any]) -> None:
    for flax_name, torch_name in (("Dense_0", "dense_0"), ("Dense_1", "dense_1"),
                                  ("pred", "pred")):
        if flax_name in params:
            _dense(sd, torch_name, params[flax_name])


def tfn_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for ``models.tfn.TFNModel`` from the variables of the JAX
    ``TFNModel``: ``params/emb_in/embedding``, ``params/conv_i/fc/Dense_0``,
    ``params/conv_i/fc_out{g}``, ``params/conv_i/_bn/{weight,bias}{k}`` and
    ``batch_stats/conv_i/_bn/{mean,var}{k}`` (with ``batch_norm``), and
    ``params/Dense_0``, ``params/Dense_1`` (or ``params/pred``).
    ``load_state_dict(..., strict=True)`` accepts the result."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {"emb_in.weight": _t(params["emb_in"]["embedding"])}
    n_layers = sum(1 for k in params if k.startswith("conv_"))
    for i in range(n_layers):
        _tp_conv(sd, f"convs.{i}", params[f"conv_{i}"],
                 stats.get(f"conv_{i}", {}))
    _readout(sd, params)
    return sd


def mace_from_jax(variables: Mapping[str, Any],
                  model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """State dict for ``model`` (a ``models.mace.MACEModel``) from the
    variables of the JAX ``MACEModel``: ``params/emb_in/embedding``,
    ``params/conv_i`` and ``batch_stats/conv_i`` (as in ``tfn_from_jax``),
    ``params/prod_i/IrrepsLinear_0/w{a}_{b}``,
    ``params/prod_i/SymmetricContraction_0/contraction_{ir}_w{nu}`` and the
    readout.  The JAX ``u_tables`` collection (the stacked U tensors) must
    equal ``model``'s U buffers to 1e-6; ``ValueError`` otherwise.
    ``load_state_dict(..., strict=True)`` accepts the result."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    tables = variables.get("u_tables", {})
    sd = {"emb_in.weight": _t(params["emb_in"]["embedding"])}
    n_layers = sum(1 for k in params if k.startswith("conv_"))
    for i in range(n_layers):
        _tp_conv(sd, f"convs.{i}", params[f"conv_{i}"],
                 stats.get(f"conv_{i}", {}))
        prod = params[f"prod_{i}"]
        for key, leaf in prod["IrrepsLinear_0"].items():
            sd[f"prods.{i}.linear.{key}"] = _t(leaf)
        for key, leaf in prod["SymmetricContraction_0"].items():
            sd[f"prods.{i}.symmetric_contraction.{key}"] = _t(leaf)
        _check_u_tables(model.prods[i].symmetric_contraction,
                        tables.get(f"prod_{i}", {}), f"prod_{i}")
    _readout(sd, params)
    return sd


def _check_u_tables(sc: torch.nn.Module, tables: Mapping[str, Any],
                    where: str) -> None:
    """The JAX ``u_tables`` of one product block
    (``SymmetricContraction_0/u{nu}``) against the port's U buffers of
    ``sc``, to 1e-6; ``ValueError`` otherwise."""
    jax_u = tables.get("SymmetricContraction_0", {})
    for nu in sc.names:
        mine = getattr(sc, f"u{nu}").detach().cpu().double().numpy()
        theirs = np.asarray(jax_u.get(f"u{nu}", np.zeros(0)), np.float64)
        if theirs.shape != mine.shape or np.abs(theirs - mine).max() > 1e-6:
            raise ValueError(f"{where}: the JAX U table u{nu} "
                             f"{theirs.shape} differs from the port's "
                             f"{mine.shape}")


def _leaves(sd: Dict[str, torch.Tensor], prefix: str,
            tree: Mapping[str, Any]) -> None:
    """Every leaf of a flax subtree under the same names at ``prefix``
    (``a/b/w0`` as ``prefix.a.b.w0``)."""
    for key, leaf in tree.items():
        if isinstance(leaf, Mapping):
            _leaves(sd, f"{prefix}.{key}", leaf)
        else:
            sd[f"{prefix}.{key}"] = _t(leaf)


def mace_ff_from_jax(variables: Mapping[str, Any],
                     model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """State dict for ``model`` (a ``models.mace_ff.MACEForceField``) from the
    variables of the JAX ``MACEForceField``, edge-chunked or not (both have
    one tree): ``params/node_embedding/w0_0``,
    ``params/interaction_i/{linear_up, conv_tp_weights/w*, linear,
    skip_tp/w*}``, ``params/product_i/{IrrepsLinear_0,
    SymmetricContraction_0}`` and ``params/readout_i``.  The JAX
    ``u_tables`` must equal ``model``'s U buffers to 1e-6; ``ValueError``
    otherwise.  ``load_state_dict(..., strict=True)`` accepts the result."""
    params = variables["params"]
    tables = variables.get("u_tables", {})
    sd: Dict[str, torch.Tensor] = {}
    _leaves(sd, "node_embedding", params["node_embedding"])
    n_layers = sum(1 for k in params if k.startswith("interaction_"))
    for i in range(n_layers):
        _leaves(sd, f"interactions.{i}", params[f"interaction_{i}"])
        prod = params[f"product_{i}"]
        _leaves(sd, f"products.{i}.linear", prod["IrrepsLinear_0"])
        _leaves(sd, f"products.{i}.symmetric_contraction",
                prod["SymmetricContraction_0"])
        _check_u_tables(model.products[i].symmetric_contraction,
                        tables.get(f"product_{i}", {}), f"product_{i}")
        _leaves(sd, f"readouts.{i}", params[f"readout_{i}"])
    return sd


def tfn_ff_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for ``models.tfn_ff.TFNForceField`` from the variables of
    the JAX ``TFNForceField``, edge-chunked or not:
    ``params/emb_in/embedding``, ``params/interaction_i/{linear_up,
    conv_tp_weights/w*, linear, skip_tp/w*}``, ``params/gates_i`` and
    ``params/Dense_0``, ``params/Dense_1``.
    ``load_state_dict(..., strict=True)`` accepts the result."""
    params = variables["params"]
    sd = {"emb_in.weight": _t(params["emb_in"]["embedding"])}
    for key, tree in params.items():
        if key.startswith("interaction_"):
            _leaves(sd, f"interactions.{key[len('interaction_'):]}", tree)
        elif key.startswith("gates_"):
            _dense(sd, f"gates.{key[len('gates_'):]}", tree)
    _dense(sd, "dense_0", params["Dense_0"])
    _dense(sd, "dense_1", params["Dense_1"])
    return sd


def _residual(sd: Dict[str, torch.Tensor], prefix: str,
              tree: Mapping[str, Any]) -> None:
    """A JAX ``ResidualLayer`` (``Dense_0``, ``Dense_1``) as the port's
    ``lin1`` / ``lin2``."""
    _dense(sd, f"{prefix}.lin1", tree["Dense_0"])
    _dense(sd, f"{prefix}.lin2", tree["Dense_1"])


def dimenet_from_jax(variables: Mapping[str, Any],
                     num_before_skip: int = 1) -> Dict[str, torch.Tensor]:
    """State dict for ``models.dimenet.DimeNetPPModel`` from the variables of
    the JAX ``DimeNetPPModel``: ``params/rbf/freq``,
    ``params/emb/{emb, Dense_0, Dense_1}``,
    ``params/interaction_b/{Dense_0..6, ResidualLayer_k, lin_sbf1,
    lin_sbf2}`` and ``params/output_b/Dense_k``; the first
    ``num_before_skip`` ResidualLayers of a block (the model's setting, 1 by
    default) are those before its skip.
    ``load_state_dict(..., strict=True)`` accepts the result."""
    params = variables["params"]
    sd = {"rbf.freq": _t(params["rbf"]["freq"]),
          "emb.emb.weight": _t(params["emb"]["emb"]["embedding"])}
    _dense(sd, "emb.lin_rbf", params["emb"]["Dense_0"])
    _dense(sd, "emb.lin", params["emb"]["Dense_1"])
    n_layers = sum(1 for k in params if k.startswith("interaction_"))
    order = ("lin_ji", "lin_kj", "lin_rbf1", "lin_rbf2", "lin_down",
             "lin_up", "lin")
    for b in range(n_layers):
        tree, prefix = params[f"interaction_{b}"], f"interactions.{b}"
        for k, name in enumerate(order):
            _dense(sd, f"{prefix}.{name}", tree[f"Dense_{k}"])
        _dense(sd, f"{prefix}.lin_sbf1", tree["lin_sbf1"])
        _dense(sd, f"{prefix}.lin_sbf2", tree["lin_sbf2"])
        res = sorted((k for k in tree if k.startswith("ResidualLayer_")),
                     key=lambda k: int(k.rsplit("_", 1)[1]))
        for k, name in enumerate(res):
            where = (f"before_skip.{k}" if k < num_before_skip
                     else f"after_skip.{k - num_before_skip}")
            _residual(sd, f"{prefix}.{where}", tree[name])
    for b in range(n_layers + 1):
        tree, prefix = params[f"output_{b}"], f"outputs.{b}"
        dense_names = sorted(tree, key=lambda k: int(k.rsplit("_", 1)[1]))
        _dense(sd, f"{prefix}.lin_rbf", tree[dense_names[0]])
        _dense(sd, f"{prefix}.lin_up", tree[dense_names[1]])
        for k, name in enumerate(dense_names[2:-1]):
            _dense(sd, f"{prefix}.lins.{k}", tree[name])
        _dense(sd, f"{prefix}.lin", tree[dense_names[-1]])
    return sd


def spherenet_from_jax(variables: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """State dict for ``models.spherenet.SphereNetModel`` from the variables
    of the JAX ``SphereNetModel``: ``params/dist_emb/freq``,
    ``params/init_e/{emb, lin_rbf_0, lin, lin_rbf_1}`` (or
    ``node_embedding``), ``params/update_e_b/{lin_*, res_before_k,
    res_after_k}`` and ``params/{init_v, update_v_b}/{lin_up, lin_k, lin}``.
    The port's modules carry the flax names (``lin_k`` as ``lins.k``,
    ``res_before_k`` as ``res_before.k``).
    ``load_state_dict(..., strict=True)`` accepts the result."""
    params = variables["params"]
    sd = {"dist_emb.freq": _t(params["dist_emb"]["freq"])}
    init_e = params["init_e"]
    if "emb" in init_e:
        sd["init_e.emb.weight"] = _t(init_e["emb"]["embedding"])
    else:
        sd["init_e.node_embedding"] = _t(init_e["node_embedding"])
    for name in ("lin_rbf_0", "lin", "lin_rbf_1"):
        _dense(sd, f"init_e.{name}", init_e[name])
    for key, tree in params.items():
        if key.startswith("update_e_"):
            prefix = f"update_es.{key[len('update_e_'):]}"
            for name, value in tree.items():
                if name.startswith(("res_before_", "res_after_")):
                    kind, k = name.rsplit("_", 1)
                    _residual(sd, f"{prefix}.{kind}.{k}", value)
                else:
                    _dense(sd, f"{prefix}.{name}", value)
        elif key == "init_v" or key.startswith("update_v_"):
            prefix = ("init_v" if key == "init_v"
                      else f"update_vs.{key[len('update_v_'):]}")
            for name, value in tree.items():
                if name in ("lin_up", "lin"):
                    _dense(sd, f"{prefix}.{name}", value)
                else:
                    _dense(sd, f"{prefix}.lins.{name[len('lin_'):]}", value)
    return sd
