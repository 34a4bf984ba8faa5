"""Device and precision policy of the port.

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``, as the tests do). With ``device=None`` and no CUDA
device, resolution raises: the port never carries on quietly on the CPU.

Float32 matrix products and convolutions run in full float32 (TF32 off):
the solver's gathers and block builds must be exact f32, and TF32 keeps
only about three decimal digits.
"""

from __future__ import annotations

import torch


def set_precision() -> None:
    """Turn TF32 off for matmuls and cuDNN (called on package import)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """None -> the current CUDA device, or RuntimeError without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "glomap_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
