"""What the port's quality harnesses share beyond torch_quality_families.py:
the hand-written kernels' launch counts, the readings of the JAX package's
harnesses that a run prints beside its own, and a cache key of a config.

Every kernel wrapper of multimodal_particles_tpu_torch/ops counts its
launches (`launches`); a harness sets the counts to 0 before a part of its
run and reads them after it, and writes them into its JSON. On the CPU the
wrappers take their plain versions and count nothing.
"""

import hashlib
import json
import os

from multimodal_particles_tpu_torch.ops.attention_cuda import attention_core
from multimodal_particles_tpu_torch.ops.epic_cuda import epic_forward
from multimodal_particles_tpu_torch.ops.epic_vjp_cuda import epic_backward
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import epic_forward_wide
from multimodal_particles_tpu_torch.ops.epic_wide_vjp_cuda import epic_backward_wide
from multimodal_particles_tpu_torch.ops.gsdm_stack_cuda import gsdm_stack
from multimodal_particles_tpu_torch.ops.sampler_cuda import sampler_step
from multimodal_particles_tpu_torch.ops.survival_cuda import survival_head

KERNELS = {
    "epic_forward": epic_forward,  # K1
    "sampler_step": sampler_step,  # K2
    "epic_backward": epic_backward,  # K3
    "epic_wide_forward": epic_forward_wide,  # K4
    "epic_wide_backward": epic_backward_wide,  # K5
    "survival_head": survival_head,  # K6
    "gsdm_stack": gsdm_stack,  # K7
    "attention_core": attention_core,  # K8
}


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0


def launches():
    """{kernel: launches since the last reset} of the kernels launched."""
    return {name: fn.launches for name, fn in KERNELS.items() if fn.launches}


def platform_of(device) -> str:
    """The device's type, "cuda" or "cpu": what the JAX harnesses' `platform`
    key held ("tpu" or "cpu")."""
    import torch

    return torch.device(device).type


def load_jax_readings(path):
    """The JSON that a JAX harness wrote (its own output format, e.g.
    benchmarks/quality_parity_mbm.json), or None without a path."""
    if not path:
        return None
    with open(path) as f:
        return json.load(f)


def jax_readings_summary(path, readings, keys=("protocol", "config", "platform")):
    """Where the JAX readings come from and at what settings: the file and
    the named keys of its top level."""
    return {"source": os.path.relpath(path), **{k: readings.get(k) for k in keys if k in readings}}


def config_key(config, **extra) -> str:
    """A short hash of a config tree's dict and `extra`: the name under which
    a harness caches what that config trains."""
    blob = json.dumps({"config": config.to_dict(), **extra}, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def write_json(path, document):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(document, f, indent=2)
