"""PyTorch/CUDA port of glomap_tpu for NVIDIA Hopper (H100).

Layout mirrors glomap_tpu (math/, ops/, estimators/, scene/, utils/) so
each function has a counterpart of the same name. The hot per-observation
sweeps run as hand-written CUDA kernels (glomap_tpu_torch/csrc/, built
with nvcc at first CUDA use, see ops/_build.py); every kernel has a plain
PyTorch version beside it in ops/kernels.py, used for CPU tensors.
"""

from glomap_tpu_torch.device import resolve_device, set_precision

set_precision()

__all__ = ["resolve_device", "set_precision"]
