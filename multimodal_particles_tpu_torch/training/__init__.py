"""Training of the PyTorch/CUDA port: the `Trainer` and the experiments
(multimodal_particles_tpu/training/__init__.py)."""

from multimodal_particles_tpu_torch.training.trainer import Trainer, TrainState  # noqa: F401
from multimodal_particles_tpu_torch.training.basic_experiments import BasicExperiment  # noqa: F401
from multimodal_particles_tpu_torch.training.multimodal_experiment import (  # noqa: F401
    MultimodalBridgeMatchingExperiment,
    train_mbm,
)
from multimodal_particles_tpu_torch.training.absorbing_experiment import (  # noqa: F401
    AbsorbingExperiment,
    train_absorbing,
)
from multimodal_particles_tpu_torch.training.transdimensional_experiment import (  # noqa: F401
    TransdimensionalExperiment,
    train_transdimensional,
)
