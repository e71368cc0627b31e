"""The MBM experiment (multimodal_particles_tpu/training/multimodal_experiment.py:15-48)."""

from multimodal_particles_tpu_torch.config_classes import MultimodalBridgeMatchingConfig
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.training.basic_experiments import BasicExperiment


class MultimodalBridgeMatchingExperiment(BasicExperiment):
    config_class = MultimodalBridgeMatchingConfig

    def setup_datamodule(self):
        self.datamodule = self.jet_datamodule()
        self.config = self.datamodule.update_config(self.config)

    def setup_model(self):
        self.model = MultiModalBridgeMatching(self.config).to(self.device)


def train_mbm(config: MultimodalBridgeMatchingConfig, device=None, seed: int = 0, experiment_dir=None):
    experiment = MultimodalBridgeMatchingExperiment(config, experiment_dir, seed=seed, device=device)
    experiment.train()
    return experiment
