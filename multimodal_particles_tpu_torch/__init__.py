"""multimodal_particles_tpu_torch — the PyTorch/CUDA port of
`multimodal_particles_tpu` for NVIDIA Hopper (H100).

The JAX package beside it is the reference: every module here names its JAX
counterpart by file and line, and the tests hold each against it on the CPU.
This package imports `torch` and never `jax`, `flax` or `optax`.

Path constants mirror the JAX package root (multimodal_particles_tpu/__init__.py:19-26).
"""

import os

base_dir = os.path.abspath(os.path.join(os.path.dirname(__file__)))
project_dir = os.path.abspath(os.path.join(base_dir, ".."))
data_dir = os.path.join(project_dir, "data")
test_resources_dir = os.path.join(project_dir, "tests", "resources")
results_dir = os.path.join(project_dir, "results")
config_dir = os.path.join(project_dir, "configs_files")

__version__ = "0.1.0"
