"""Device resolution for the port's entry points.

The port runs on the card.  An entry point given no device takes
``cuda``; with no card it raises rather than drifting onto the CPU, so
a run that meant to measure the device can never silently measure the
host.  The CPU is used only when the caller asks for it, as the tests
do (``device="cpu"``), and then every kernel wrapper takes its plain
PyTorch version.
"""

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> the CPU; a CUDA device is
    checked to exist.  Raises ``RuntimeError`` when CUDA is asked for
    (explicitly or by default) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card. "
                "Pass device='cpu' to run the plain PyTorch path on "
                "the CPU."
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev
