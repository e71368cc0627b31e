"""Experiment directory layout for the trainer's checkpoints and metrics: the
part of multimodal_particles_tpu/utils/experiment_files.py (`ExperimentsFiles`)
that `Trainer` reads, with the same names and paths. The port keeps its own
copy because nothing on its path may import the JAX package."""

import os


class ExperimentsFiles:
    """logs/metrics.jsonl and checkpoints/<tag>/ under `experiment_dir`."""

    def __init__(self, experiment_dir: str):
        self.experiment_dir = experiment_dir
        self.logs_dir = os.path.join(experiment_dir, "logs")
        self.checkpoints_dir = os.path.join(experiment_dir, "checkpoints")
        for d in (self.logs_dir, self.checkpoints_dir):
            os.makedirs(d, exist_ok=True)
        self.metrics_file = os.path.join(self.logs_dir, "metrics.jsonl")

    def checkpoint_path(self, tag: str) -> str:
        return os.path.join(self.checkpoints_dir, tag)

    def get_checkpoint_path(self, checkpoint_type: str = "best") -> str:
        """Resolve the 'best' or 'last' checkpoint directory."""
        path = self.checkpoint_path(checkpoint_type)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no {checkpoint_type!r} checkpoint in {self.checkpoints_dir}")
        return path
