"""Published peaks of the cards the benchmark knows (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit)."""

from __future__ import annotations

from typing import Optional

H100 = {"f32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12}


def for_device(kind: str) -> Optional[dict]:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    None for a card (or a CPU) this table lacks."""
    return H100 if "H100" in kind else None
