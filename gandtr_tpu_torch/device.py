"""Device selection and the float32 numerics policy of the port.

`resolve_device(None)` is `cuda`; without a GPU it raises instead of running
on the CPU quietly. Only an explicit `device="cpu"` runs on the CPU.

TF32 is switched off here, in one place, for both cuDNN convolutions and
CUDA matmuls: the reference evaluation runs in float32, and TF32 keeps only
about three decimal digits (cuDNN enables it for convolutions by default).
cuDNN is also held to deterministic algorithms (a transposed convolution
may otherwise sum with atomics), so a served image is the same bit for bit
however often it is computed. Every entry point calls `resolve_device`, so
the policy holds before any work reaches the card.
"""
import numpy as np
import torch


def set_float32_policy():
    """Full float32 on the card: TF32 off for convolutions and matmuls;
    deterministic cuDNN algorithms."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def resolve_device(device=None):
    """`None` -> `cuda`; raises when CUDA is requested but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gandtr_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU")
        set_float32_policy()
    return dev


def upload(arr, device):
    """A host array as a tensor on `device`. To the card the copy goes from
    pinned memory, asynchronously: the host goes on while it runs."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
