"""Experiment wiring: a config → the jet datamodule, the model and the
`Trainer`, and the run directory (params.yaml, checkpoints, metrics); the
counterpart of multimodal_particles_tpu/training/basic_experiments.py:12-50.

The experiments are the port's entry points from a config, so they run on
the card unless the caller asks for another device: `device=None` means
`cuda`, and with no CUDA device that raises (pass `device="cpu"` to run on
the CPU). `seed` seeds the parameters, the bridge noise and the data's noise
(the source clouds): a run directory reloads to the same state with the same
seed.
"""

import os
from abc import ABC, abstractmethod

import numpy as np
import torch

from multimodal_particles_tpu_torch.data.particle_clouds.jets import JetDataclass
from multimodal_particles_tpu_torch.data.particle_clouds.jets_dataloader import (
    JetsDataloaderModule,
)
from multimodal_particles_tpu_torch.training.trainer import Trainer
from multimodal_particles_tpu_torch.utils.experiment_files import ExperimentsFiles


def resolve_device(device=None) -> torch.device:
    """`cuda` unless `device` names another; a CUDA device that is not there
    raises rather than falling back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the experiments run on the GPU by default; "
            "pass device='cpu' (or --device cpu) to run on the CPU"
        )
    return device


def attach_contexts(jets, config, contexts):
    """Set on `jets` the contexts that the config asks for, from `contexts`
    ({"context_continuous": (num_jets, Dcc) floats, "context_discrete":
    (num_jets, Dcd) tokens}, one row a jet in the shard's order); the
    datamodule then carries them in every batch. The bundled jet readers give
    no context, in the JAX package too, so a config with one needs them from
    the caller."""
    d, contexts = config.data, contexts or {}
    for name, width in (("context_continuous", d.dim_context_continuous),
                        ("context_discrete", d.dim_context_discrete)):
        if not width:
            continue
        if name not in contexts:
            raise ValueError(
                f"the config has a {name} of width {width}, and the jet readers give no "
                f"context: pass it as contexts={{'{name}': array (num_jets, {width})}}")
        value = np.asarray(contexts[name])
        if value.shape != (len(jets.target), width):
            raise ValueError(f"{name} has shape {value.shape}; the shard's jets want "
                             f"{(len(jets.target), width)}")
        setattr(jets, name, value)


class BasicExperiment(ABC):
    """A new run from `config` (into `experiment_dir`, or the config's, or
    results/<timestamp>), or, with `config=None`, the run in `experiment_dir`
    reloaded: its params.yaml, the datamodule and model rebuilt, and the
    'best' checkpoint. Subclasses name their `config_class` and build the
    datamodule and the model. A config with a context takes `contexts` (see
    `attach_contexts`), for a reloaded run too."""

    config_class = None

    def __init__(self, config=None, experiment_dir=None, seed: int = 0, device=None,
                 contexts=None):
        self.seed = seed
        self.contexts = contexts
        self.device = resolve_device(device)
        if config is not None:
            self.config = config
            self.experiment_files = ExperimentsFiles(
                experiment_dir=experiment_dir or getattr(config, "experiment_dir", None),
                experiment_indentifier=getattr(config, "experiment_indentifier", None),
            )
            self.setup_datamodule()
            self.setup_model()
            self.config.to_yaml(self.experiment_files.params_yaml)
            self.trainer = Trainer(self.model, self.config, self.experiment_files, seed=seed)
        elif experiment_dir is not None:
            self.load_from_experiment_dir(experiment_dir)
        else:
            raise ValueError("give a config for a new run or the experiment_dir of one")

    def jet_datamodule(self) -> JetsDataloaderModule:
        """The config's jets, preprocessed (which writes the stats into the
        config), with the experiment's contexts, in a datamodule on the
        experiment's device."""
        jets = JetDataclass(self.config, seed=self.seed)
        jets.preprocess()
        attach_contexts(jets, self.config, self.contexts)
        return JetsDataloaderModule(self.config, jets, device=self.device)

    @abstractmethod
    def setup_datamodule(self):
        ...

    @abstractmethod
    def setup_model(self):
        ...

    def load_from_experiment_dir(self, experiment_dir):
        """Rebuild the run in `experiment_dir` from its params.yaml and load
        its 'best' checkpoint (multimodal_experiment.py:27-42)."""
        self.config = self.config_class.from_yaml(os.path.join(experiment_dir, "params.yaml"))
        self.experiment_files = ExperimentsFiles(experiment_dir=experiment_dir)
        self.setup_datamodule()
        self.setup_model()
        self.trainer = Trainer(self.model, self.config, self.experiment_files, seed=self.seed)
        self.trainer.setup(max(len(self.datamodule.train), 1))
        self.trainer.load_checkpoint("best")

    def train(self, epochs=None):
        """`Trainer.fit` for `epochs`, the config's by default."""
        return self.trainer.fit(self.datamodule, epochs)

    def generate(self):
        """`Trainer.predict` over the test batches, else the validation ones:
        the final states, with the EMA weights when EMA is on."""
        return self.trainer.predict(self.datamodule)
