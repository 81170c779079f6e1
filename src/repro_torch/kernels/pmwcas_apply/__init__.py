"""Batched deterministic MwCAS: the Hopper kernel, its plain PyTorch
version and the device-dispatching public ops."""
