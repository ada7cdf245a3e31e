"""The port's device rule: every entry point runs on the card unless the
caller asks for the CPU."""

import torch


def resolve_device(device=None) -> torch.device:
    """device=None means "cuda", and raises when there is no CUDA device;
    anything else is taken as given (device="cpu" runs the plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
