from setuptools import find_packages, setup

setup(
    name="multimodal_particles_tpu",
    version="0.1.0",
    description=(
        "TPU-native JAX framework for generative modeling of multimodal "
        "particle clouds (hybrid bridges, absorbing flows, transdimensional "
        "jump diffusion)"
    ),
    packages=find_packages(exclude=("tests", "tests.*")),
    package_data={
        "multimodal_particles_tpu.native": ["*.cpp"],
        "multimodal_particles_tpu_torch.ops": ["csrc/*.cu", "csrc/*.cuh"],
    },
    python_requires=">=3.10",
)
