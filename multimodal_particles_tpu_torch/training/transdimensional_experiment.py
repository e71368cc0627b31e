"""The transdimensional experiment
(multimodal_particles_tpu/training/transdimensional_experiment.py:17-49): 'list'
batches, and the datamodule's graphical structure (its multiplicity
histogram is the sampler's prior) handed to the model."""

from multimodal_particles_tpu_torch.config_classes import TransdimensionalEpicConfig
from multimodal_particles_tpu_torch.models.generative.transdimensional.transdimensional_model import (
    TransdimensionalJumpDiffusion,
)
from multimodal_particles_tpu_torch.training.basic_experiments import BasicExperiment


class TransdimensionalExperiment(BasicExperiment):
    config_class = TransdimensionalEpicConfig

    def setup_datamodule(self):
        self.config.data.return_type = "list"
        self.datamodule = self.jet_datamodule()

    def setup_model(self):
        self.model = TransdimensionalJumpDiffusion(self.config, self.datamodule).to(self.device)


def train_transdimensional(config: TransdimensionalEpicConfig, device=None, seed: int = 0,
                           experiment_dir=None, contexts=None):
    experiment = TransdimensionalExperiment(config, experiment_dir, seed=seed, device=device,
                                            contexts=contexts)
    experiment.train()
    return experiment
