"""Config dataclasses that the MBM sampler slice reads.

A field-for-field mirror of the data, encoder, bridge and parallel sections of
multimodal_particles_tpu/config_classes/multimodal_bridge_matching_config.py:32-137
(same names, same defaults; tests/test_torch_epic.py asserts the equality).
The port keeps its own copy so that nothing on its path imports the JAX
package: `multimodal_particles_tpu/__init__` and its `data` subpackage pull in
modules (h5py) that the GPU machine does not have.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union


@dataclass
class JetsDataConfig:
    # target
    target_name: str = "AspenOpenJets"
    target_path: Optional[List[str]] = None
    target_preprocess_continuous: str = "standardize"
    target_preprocess_discrete: str = "tokens"
    target_info: Dict[str, Union[list, dict, None]] = field(
        default_factory=lambda: {"stats": None, "hist_num_particles": None}
    )
    # source
    source_name: str = "GaussNoise"
    source_path: Optional[List[str]] = None
    source_preprocess_continuous: Optional[str] = None
    source_preprocess_discrete: str = "tokens"
    source_info: Dict[str, Union[list, dict, None]] = field(
        default_factory=lambda: {"stats": None, "hist_num_particles": None}
    )
    source_masks_from_target_masks: bool = True
    fill_target_with_noise: bool = True

    # dimensions
    min_num_particles: int = 0
    max_num_particles: int = 128
    num_jets: int = 1000
    dim_features_continuous: int = 3
    dim_features_discrete: int = 1
    dim_context_continuous: int = 0
    dim_context_discrete: int = 0
    vocab_size_features: int = 8
    vocab_size_context: int = 0
    return_type: str = "namedtuple"

    batch_size: int = 1024
    data_split_frac: List[float] = field(default_factory=lambda: [0.8, 0.2, 0.0])

    source_preprocess_stats: Optional[dict] = None
    target_preprocess_stats: Optional[dict] = None


@dataclass
class BridgeConfig:
    continuous: str = "LinearUniformBridge"
    discrete: str = "TelegraphBridge"
    sigma: float = 0.0001
    gamma: float = 0.125
    num_timesteps: int = 1000
    time_eps: float = 0.0001


@dataclass
class EncoderConfig:
    name: str = "MultiModalEPiC"
    num_blocks: int = 2
    embedding_time: str = "SinusoidalPositionalEncoding"
    embedding_features_continuous: str = "Linear"
    embedding_features_discrete: str = "Embedding"
    embedding_context_continuous: Optional[str] = None
    embedding_context_discrete: Optional[str] = None
    dim_hidden_local: int = 16
    dim_hidden_glob: int = 16
    dim_emb_time: int = 16
    dim_emb_features_continuous: int = 16
    dim_emb_features_discrete: int = 16
    dim_emb_context_continuous: int = 0
    dim_emb_context_discrete: int = 0
    skip_connection: bool = True
    dropout: float = 0.1
    activation: str = "SELU"
    add_discrete_head: bool = True


@dataclass
class ParallelConfig:
    data_axis: int = -1
    model_axis: int = 1
    compute_dtype: str = "float32"
    donate_buffers: bool = True
    # hand-written CUDA kernels on the sampling path: True / False / 'auto'
    # ('auto' = on for CUDA tensors when the encoder matches the kernels)
    use_pallas: object = "auto"
    spmd_mode: str = "jit"
    skip_nonfinite_updates: bool = False


@dataclass
class MultimodalBridgeMatchingConfig:
    name_str: str = "ExampleModel"
    bridge: BridgeConfig = field(default_factory=BridgeConfig)
    data: JetsDataConfig = field(default_factory=JetsDataConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    @staticmethod
    def from_dict(config_dict: dict) -> "MultimodalBridgeMatchingConfig":
        """Build from a nested dict (e.g. the JAX config's `to_dict()`);
        unknown sections and keys are ignored."""
        return MultimodalBridgeMatchingConfig(
            name_str=config_dict.get("name_str", "ExampleModel"),
            bridge=_build(BridgeConfig, config_dict.get("bridge", {})),
            data=_build(JetsDataConfig, config_dict.get("data", {})),
            encoder=_build(EncoderConfig, config_dict.get("encoder", {})),
            parallel=_build(ParallelConfig, config_dict.get("parallel", {})),
        )


def _build(cls, d: dict):
    known = set(cls.__dataclass_fields__)
    return cls(**{k: v for k, v in d.items() if k in known})
