"""Models of the port, and their registry by the JAX package's names."""

from .dimenet import DimeNetPPModel  # noqa: F401
from .egnn import EGNNLayer, EGNNModel, MPNNLayer, MPNNModel  # noqa: F401
from .egnn_fused import EGNNFusedModel, FusedEGNNLayer  # noqa: F401
from .gnn101 import (CoordMPNNModel, EquivariantMPNNLayer,  # noqa: F401
                     FinalMPNNModel, InvariantMPNNLayer,
                     InvariantMPNNModel, MPNN101Layer)
from .gvpgnn import GVPConv, GVPConvLayer, GVPGNNModel  # noqa: F401
from .mace import MACEModel  # noqa: F401
from .mace_ff import MACEForceField  # noqa: F401
from .schnet import SchNetInteraction, SchNetModel  # noqa: F401
from .spherenet import SphereNetModel  # noqa: F401
from .tfn import TFNModel  # noqa: F401
from .tfn_ff import TFNForceField  # noqa: F401

model_registry = {
    "schnet": SchNetModel,
    "egnn": EGNNModel,
    "mpnn": MPNNModel,
    "egnn_fused": EGNNFusedModel,
    "gvp": GVPGNNModel,
    "tfn": TFNModel,
    "mace": MACEModel,
    "dimenet": DimeNetPPModel,
    "spherenet": SphereNetModel,
    "mace_ff": MACEForceField,
    "tfn_ff": TFNForceField,
}
