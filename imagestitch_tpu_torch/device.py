"""The port's device policy: every entry point takes the card unless the
caller asks for the CPU, and none falls back to it."""
import torch


def resolve_device(device, caller: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises,
    naming ``device='cpu'`` (no entry point falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}(device={str(device)!r}): "
                           f"torch.cuda.is_available() is False; pass "
                           f"device='cpu' to run on the CPU")
    return device
