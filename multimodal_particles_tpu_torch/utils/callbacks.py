"""Training callbacks (multimodal_particles_tpu/utils/callbacks.py:1-46): an
MLflow logger of the best checkpoint and an append-only JSONL writer.
mlflow is imported where it is used; without it the MLflow callback does
nothing."""

import json
import os


class MLflowCallback:
    """Logs the best checkpoint directory as an MLflow artifact at the end
    of training: call `on_train_end(trainer)` after `Trainer.fit`."""

    def __init__(self, tracking_uri=None):
        self.tracking_uri = tracking_uri

    def on_train_end(self, trainer):
        """The best checkpoint directory, logged when a run is active; None
        without mlflow or without a run directory."""
        try:
            import mlflow
        except ImportError:
            return None
        if self.tracking_uri:
            mlflow.set_tracking_uri(self.tracking_uri)
        if trainer.files is None:
            return None
        best = trainer.files.checkpoint_path("best")
        if os.path.isdir(best) and mlflow.active_run() is not None:
            mlflow.log_artifacts(best, artifact_path="checkpoints/best")
        return best


class JSONLMetricsCallback:
    """Append-only JSONL metrics writer for records beside the Trainer's
    own epoch records."""

    def __init__(self, path):
        self.path = path

    def log(self, record: dict):
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
