#!/usr/bin/env python3
"""What one training step spends on the host to make the narrow kernels'
buffers: the operations PyTorch dispatches, and on a GPU the kernels it
launches, for the buffers the config-berlin training forward makes from the
non-leaf packed weights at every step.

    python3 scripts/buffer_launches.py [--other DIR]

This tree's training forward makes one buffer that K1 and K3 both read
(`narrow_buffer(flat, dims)`). DIR, another revision's root (for example
the parent unpacked with `git archive`), adds that revision's
`multimodal_particles_tpu_torch/ops/epic_cuda.py::narrow_buffer` at the same
weights: K1's buffer alone before K3 read one. Operations are counted with a
TorchDispatchMode (on the CPU or the GPU), kernels with torch.profiler (GPU
only), each over one call after a first call that makes the cached plan.
One JSON line a revision.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from multimodal_particles_tpu_torch.config_classes import MultimodalBridgeMatchingConfig  # noqa: E402
from multimodal_particles_tpu_torch.models.generative.init import init_mbm_parameters  # noqa: E402
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (  # noqa: E402
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.ops import epic_cuda  # noqa: E402


class CountOperations(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


def measure(make, flat, device):
    """(operations, device kernels or None) of one call of make(flat)."""
    make(flat)
    with CountOperations() as counted:
        make(flat)
    kernels = None
    if device.type == "cuda":
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            make(flat)
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA"))
    return counted.count, kernels


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", type=Path, help="another revision's root")
    args = parser.parse_args()
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    model = init_mbm_parameters(MultiModalBridgeMatching(MultimodalBridgeMatchingConfig()), 0)
    model = model.to(device)
    packed = epic_cuda.pack_mbm_encoder_params(model.encoder, model.config, differentiable=True)
    d = packed.dims
    runs = {"here": lambda flat: epic_cuda.narrow_buffer(flat, d)}
    if args.other is not None:
        path = args.other / "multimodal_particles_tpu_torch" / "ops" / "epic_cuda.py"
        spec = importlib.util.spec_from_file_location("other_epic_cuda", path)
        other = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(other)
        other_dims = other.EpicDims(**{f: getattr(d, f) for f in d.__dataclass_fields__})
        runs["other"] = lambda flat: other.narrow_buffer(flat, other_dims)
    for name, make in runs.items():
        operations, kernels = measure(make, packed.flat, device)
        print(json.dumps({"revision": name, "device": str(device), "operations": operations,
                          "device_kernels": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
