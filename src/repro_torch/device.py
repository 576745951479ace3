"""Device policy of the port's entry points.

Engines, servicers and launchers run on the CUDA card unless the caller
asks for the CPU (``device="cpu"``, as the tests do).  With no card and no
explicit request they raise: nothing silently continues on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the first CUDA card; a CUDA device with no card
    present raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); pass device='cpu' to run on the CPU")
    return dev
