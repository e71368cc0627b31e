"""Experiment directory layout: a run directory with logs/, checkpoints/ and
the config snapshot params.yaml, the part of
multimodal_particles_tpu/utils/experiment_files.py:1-62 that the port's
`Trainer` and experiments read, with the same names and paths. The port
keeps its own copy because nothing on its path may import the JAX package."""

import datetime
import os


class ExperimentsFiles:
    """Creates (or attaches to) an experiment directory tree: by default
    results/<experiment_indentifier>, a timestamp unless given."""

    def __init__(self, experiment_dir=None, experiment_indentifier=None):
        if experiment_indentifier is None:
            experiment_indentifier = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        if experiment_dir is None:
            from multimodal_particles_tpu_torch import results_dir

            experiment_dir = os.path.join(results_dir, experiment_indentifier)
        self.experiment_indentifier = experiment_indentifier
        self.experiment_dir = experiment_dir

        self.logs_dir = os.path.join(self.experiment_dir, "logs")
        self.checkpoints_dir = os.path.join(self.experiment_dir, "checkpoints")
        for d in (self.logs_dir, self.checkpoints_dir):
            os.makedirs(d, exist_ok=True)

        self.params_yaml = os.path.join(self.experiment_dir, "params.yaml")
        self.metrics_file = os.path.join(self.logs_dir, "metrics.jsonl")

    def checkpoint_path(self, tag: str) -> str:
        return os.path.join(self.checkpoints_dir, tag)

    def get_checkpoint_path(self, checkpoint_type: str = "best") -> str:
        """Resolve the 'best' or 'last' checkpoint directory."""
        path = self.checkpoint_path(checkpoint_type)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no {checkpoint_type!r} checkpoint in {self.checkpoints_dir}")
        return path
