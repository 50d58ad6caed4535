"""Device resolution for the port's entry points.

Every entry point takes ``device=`` defaulting to ``"cuda"``.  With no
CUDA device that raises: the port never drops to the CPU on its own.
The CPU is chosen only by asking for it (``device="cpu"``), which runs
each kernel's plain PyTorch version.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it is a CUDA
    device and no CUDA device is present, or if it is neither CUDA nor
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "apex_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"apex_tpu_torch runs on 'cuda' or 'cpu', got {device!r}")
    return dev
