"""The absorbing-flow experiment (multimodal_particles_tpu/training/absorbing_experiment.py:14-46)."""

from multimodal_particles_tpu_torch.config_classes import AbsorbingConfig
from multimodal_particles_tpu_torch.models.generative.absorbing.absorbing_flows import (
    AbsorbingFlow,
)
from multimodal_particles_tpu_torch.training.basic_experiments import BasicExperiment


class AbsorbingExperiment(BasicExperiment):
    config_class = AbsorbingConfig

    def setup_datamodule(self):
        self.datamodule = self.jet_datamodule()
        self.config = self.datamodule.update_config(self.config)

    def setup_model(self):
        self.model = AbsorbingFlow(self.config).to(self.device)


def train_absorbing(config: AbsorbingConfig, device=None, seed: int = 0, experiment_dir=None):
    experiment = AbsorbingExperiment(config, experiment_dir, seed=seed, device=device)
    experiment.train()
    return experiment
