"""Production meshes and the card's constants.

The port of ``repro/launch/mesh.py``.  The device counts stay the
reference's, 256 and 512, laid out as H100 nodes of 8 GPUs joined by
NVLink: the model axis is one node's 8 cards, so tensor-parallel
collectives stay on NVLink, and the data (and pod) axes run across nodes.
The reference's ``(16, 16)`` and ``(2, 16, 16)`` are a TPU pod's torus; a
model axis of 16 would span two H100 nodes.  These are shapes only
(:class:`repro_torch.parallel.sharding.Mesh`): nothing here starts a
process group or touches a device but :func:`make_host_mesh`, which
counts the local cards.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.sharding import Mesh
from repro_torch.pmwcas import resolve_device

GPUS_PER_NODE = 8


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """32 nodes x 8 GPUs = 256 cards; two such pods = 512 when
    ``multi_pod``."""
    if multi_pod:
        return Mesh((2, 32, GPUS_PER_NODE), ("pod", "data", "model"))
    return Mesh((32, GPUS_PER_NODE), ("data", "model"))


def make_host_mesh(device="cuda") -> Mesh:
    """The local cards as ``(n, 1)`` over ``("data", "model")``; ``(1,
    1)`` when the CPU is asked for.  Raises for ``"cuda"`` without a
    card."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return Mesh((n, 1), ("data", "model"))


# one NVIDIA H100 SXM (NVIDIA's H100 data sheet; dense, no sparsity)
PEAK_FLOPS_BF16 = 989e12     # bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12             # HBM3 bytes/s per card
NVLINK_BW = 450e9            # NVLink bytes/s per card, each direction
HBM_BYTES = 80e9             # device memory per card
