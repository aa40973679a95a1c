"""Device selection and the card's numeric settings."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` unless the caller asks for another device. Raises when CUDA is
    requested (explicitly or by default) and absent: nothing falls back to the
    CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


def set_precision_flags() -> None:
    """fp32 matmuls and convolutions in full fp32, never TF32. bf16 work runs
    under autocast; what the model pins to fp32 (the TCP-frame math above all,
    see docs/design.md "Precision policy") must stay fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
