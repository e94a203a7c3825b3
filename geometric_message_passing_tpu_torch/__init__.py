"""geometric_message_passing_tpu_torch — the PyTorch/CUDA port of
``geometric_message_passing_tpu``.

The JAX package beside it is the reference this port is held against; this
package imports neither JAX nor anything of the JAX package.  Module names
mirror the JAX package so each counterpart is easy to find.

Entry points take an explicit ``device=``.  It defaults to ``"cuda"`` and
raises when CUDA is absent: nothing drops to the CPU on its own.  Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev
