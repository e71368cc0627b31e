"""Free-form nested config loader: recursive dict → namespace `Configs`
objects with automatic experiment naming, for the reference's nested
config-berlin.yaml-style schema; the port's copy of
multimodal_particles_tpu/utils/experiment_configs.py:1-110 (reference:
utils/experiment_configs.py:10-203). The typed dataclass trees in
`config_classes.py` are the port's canonical configs."""

import datetime
import os
import types

import yaml


def yaml_to_namespace(data):
    """Recursively convert dicts/lists to SimpleNamespace trees
    (reference: experiment_configs.py:10-24)."""
    if isinstance(data, dict):
        return types.SimpleNamespace(
            **{k: yaml_to_namespace(v) for k, v in data.items()}
        )
    if isinstance(data, list):
        return [yaml_to_namespace(v) for v in data]
    return data


def namespace_to_dict(ns):
    if isinstance(ns, types.SimpleNamespace) or isinstance(ns, Configs):
        return {k: namespace_to_dict(v) for k, v in vars(ns).items()}
    if isinstance(ns, list):
        return [namespace_to_dict(v) for v in ns]
    return ns


def load_config(path):
    """YAML file → Configs object (reference: experiment_configs.py:50-70)."""
    with open(path, "r") as f:
        data = yaml.safe_load(f)
    return Configs(data)


class Configs:
    """Recursive namespace config with experiment naming and save/print
    helpers (reference: experiment_configs.py:72-203)."""

    def __init__(self, config_source):
        if isinstance(config_source, str):
            with open(config_source, "r") as f:
                config_source = yaml.safe_load(f)
        if not isinstance(config_source, dict):
            raise ValueError("Configs expects a dict or a yaml path")
        self._set_attributes(config_source)

        if hasattr(self, "experiment"):
            if getattr(self.experiment, "experiment_indentifier", None) is None:
                self.experiment.experiment_indentifier = datetime.datetime.now().strftime(
                    "%Y-%m-%d_%H-%M-%S"
                )
            if not hasattr(self.experiment, "experiment_name") or (
                self.experiment.experiment_name is None
            ):
                name = getattr(self.experiment, "type", "experiment")
                if hasattr(self, "data"):
                    for attr in ("target", "target_name"):
                        target = getattr(self.data, attr, None)
                        if target is not None:
                            tname = getattr(target, "name", target)
                            name = f"{name}_{tname}"
                            break
                self.experiment.experiment_name = name

    def _set_attributes(self, config_dict):
        for key, value in config_dict.items():
            if isinstance(value, dict):
                sub = Configs.__new__(Configs)
                sub._set_attributes(value)
                setattr(self, key, sub)
            else:
                setattr(self, key, value)

    def to_dict(self):
        return namespace_to_dict(self)

    def save(self, path):
        with open(path, "w") as f:
            yaml.dump(self.to_dict(), f, default_flow_style=False)

    def print(self):
        yaml_str = yaml.dump(self.to_dict(), default_flow_style=False)
        print(yaml_str)

    def log_config(self, logger):
        """Log flattened key/values to any logger exposing log_hyperparams
        or log_params."""
        flat = {}

        def walk(prefix, d):
            for k, v in d.items():
                key = f"{prefix}.{k}" if prefix else k
                if isinstance(v, dict):
                    walk(key, v)
                else:
                    flat[key] = v

        walk("", self.to_dict())
        if hasattr(logger, "log_hyperparams"):
            logger.log_hyperparams(flat)
        elif hasattr(logger, "log_params"):
            logger.log_params(flat)
        return flat
