"""Partition-aware multi-device solvers on torch.distributed."""
