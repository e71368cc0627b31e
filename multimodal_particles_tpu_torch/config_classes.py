"""Config dataclasses that the ported model families read.

A field-for-field mirror of the train, data, encoder, bridge and parallel
sections of
multimodal_particles_tpu/config_classes/multimodal_bridge_matching_config.py:16-137
(same names, same defaults; tests/test_torch_epic.py asserts the equality)
and of the absorbing family's own data, bridge and generator sections,
multimodal_particles_tpu/config_classes/absorbing_flows_config.py:21-157
(tests/test_torch_absorbing.py asserts that one), and of the transdimensional
family's tree,
multimodal_particles_tpu/config_classes/transdimensional_unconditional_config.py:19-331
(tests/test_torch_transdim.py asserts that one; that file's comments say why
each sampler and loss default is what it is). The transdimensional data and
encoder sections are `TransdimJetsDataConfig` and `TransdimEncoderConfig`
here, since this one module holds every family's sections.
The port keeps its own copy so that nothing on its path imports the JAX
package: `multimodal_particles_tpu/__init__` and its `data` subpackage pull in
modules (h5py) that the GPU machine does not have.
"""

from dataclasses import asdict, dataclass, field, fields, is_dataclass
from typing import Dict, List, Optional, Union


@dataclass
class TrainingConfig:
    epochs: int = 200
    gradient_clip_val: float = 1.0
    optimizer_name: str = "AdamW"
    lr: float = 0.001
    weight_decay: float = 5.0e-5
    betas: List[float] = field(default_factory=lambda: [0.9, 0.999])
    eps: float = 1.0e-8
    amsgrad: bool = False
    scheduler_name: str = "CosineAnnealingLR"
    scheduler_params: Dict[str, Union[float, int]] = field(
        default_factory=lambda: {"T_max": 1000, "eta_min": 5.0e-5, "last_epoch": -1}
    )


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
    # hand-written CUDA kernels on the sampling and training paths:
    # True / False / 'auto' ('auto' = on for CUDA tensors when the encoder
    # matches the kernels)
    use_pallas: object = "auto"
    spmd_mode: str = "jit"
    skip_nonfinite_updates: bool = False


@dataclass
class MultimodalBridgeMatchingConfig:
    name_str: str = "ExampleModel"
    bridge: BridgeConfig = field(default_factory=BridgeConfig)
    data: JetsDataConfig = field(default_factory=JetsDataConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    train: TrainingConfig = field(default_factory=TrainingConfig)
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
            train=_build(TrainingConfig, config_dict.get("train", {})),
            parallel=_build(ParallelConfig, config_dict.get("parallel", {})),
        )


@dataclass
class AbsorbingJetsDataConfig(JetsDataConfig):
    """The absorbing family's data section: the MBM fields with its own
    defaults for the slot count and the batch (absorbing_flows_config.py:21-55)."""

    max_num_particles: int = 109
    batch_size: int = 28


@dataclass
class AbsorbingBridgeConfig:
    """absorbing_flows_config.py:58-99. `target_dropout` > 0 drops each target
    slot from the training mask with probability dropout·SP(t);
    `death_rate_scale` > 0 switches the sampler's death channel on. Both are 0
    in the reference semantics."""

    continuous: str = "LinearUniformBridge"
    discrete: str = "TelegraphBridge"
    absorbing: str = "AbsorbingBridge"
    sigma: float = 0.0001
    gamma: float = 0.125
    gamma_absorb: float = 0.125
    num_timesteps: int = 1000
    time_eps: float = 0.0001
    target_dropout: float = 0.0
    death_rate_scale: float = 0.0


@dataclass
class GeneratorsHeadConfig:
    """Heads for survival-rate prediction (absorbing_flows_config.py:102-113)."""

    rate_use_x0_pred: bool = True
    transformer_dim: int = 128
    temb_dim: int = 128
    n_heads: int = 2
    n_attn_blocks: int = 2
    detach_last_layer: bool = True
    augment_dim: int = 9
    discrete_head_hidden_dim: int = 56


@dataclass
class AbsorbingConfig:
    name_str: str = "ExampleModel"
    experiment_name: str = "absorbing_flows"
    experiment_indentifier: Optional[str] = None
    experiment_dir: Optional[str] = None

    bridge: AbsorbingBridgeConfig = field(default_factory=AbsorbingBridgeConfig)
    data: AbsorbingJetsDataConfig = field(default_factory=AbsorbingJetsDataConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    generator: GeneratorsHeadConfig = field(default_factory=GeneratorsHeadConfig)
    train: TrainingConfig = field(default_factory=TrainingConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    @staticmethod
    def from_dict(config_dict: dict) -> "AbsorbingConfig":
        """Build from a nested dict (e.g. the JAX config's `to_dict()`);
        unknown sections and keys are ignored."""
        return AbsorbingConfig(
            name_str=config_dict.get("name_str", "ExampleModel"),
            experiment_name=config_dict.get("experiment_name", "absorbing_flows"),
            experiment_indentifier=config_dict.get("experiment_indentifier"),
            experiment_dir=config_dict.get("experiment_dir"),
            bridge=_build(AbsorbingBridgeConfig, config_dict.get("bridge", {})),
            data=_build(AbsorbingJetsDataConfig, config_dict.get("data", {})),
            encoder=_build(EncoderConfig, config_dict.get("encoder", {})),
            generator=_build(GeneratorsHeadConfig, config_dict.get("generator", {})),
            train=_build(TrainingConfig, config_dict.get("train", {})),
            parallel=_build(ParallelConfig, config_dict.get("parallel", {})),
        )


# ------------------------------------------------- the transdimensional family


@dataclass
class TransdimJetsDataConfig:
    target_name: str = "AspenOpenJets"
    target_path: Optional[List[str]] = None
    target_preprocess_continuous: str = "standardize"
    target_preprocess_discrete: str = "tokens"
    target_info: Dict[str, Union[list, dict, None]] = field(
        default_factory=lambda: {"stats": None, "hist_num_particles": None}
    )
    source_name: str = "GaussNoise"
    source_path: Optional[List[str]] = None
    source_preprocess_continuous: Optional[str] = None
    source_preprocess_discrete: str = "tokens"
    source_info: Dict[str, Union[list, dict, None]] = field(
        default_factory=lambda: {"stats": None, "hist_num_particles": None}
    )
    source_masks_from_target_masks: bool = True
    fill_target_with_noise: bool = False

    min_num_particles: int = 0
    max_num_particles: int = 128
    num_jets: int = 100
    dim_features_continuous: int = 3
    dim_features_discrete: int = 1
    dim_context_continuous: int = 0
    dim_context_discrete: int = 0
    vocab_size_features: int = 8
    vocab_size_context: int = 0

    return_type: str = "namedtuple"

    graphical_structure: str = ""
    exist: Optional[List[int]] = None
    observed: Optional[List[int]] = None

    batch_size: int = 28
    data_split_frac: List[float] = field(default_factory=lambda: [0.8, 0.2, 0.0])

    source_preprocess_stats: Optional[dict] = None
    target_preprocess_stats: Optional[dict] = None


@dataclass
class LossKwargs:
    class_name: str = "training.loss.JumpLossFinalDim"
    score_loss_weight: float = 1.0
    rate_loss_weight: float = 1.0
    min_t: float = 0.001
    mean_or_sum_over_dim: str = "mean"
    nearest_atom_pred: bool = True
    rate_function_name: str = "step"
    noise_schedule_name: str = "vp_sde"
    auto_loss_weight: float = 1.0
    vp_sde_beta_max: float = 20.0
    nearest_atom_loss_weight: float = 1.0
    x0_logit_ce_loss_weight: float = 1.0
    vp_sde_beta_min: float = 0.1
    loss_type: str = "eps"
    rate_cut_t: float = 0.1
    score_loss_normalization: str = "live"


@dataclass
class OptimizerKwargs:
    class_name: str = "torch.optim.Adam"
    lr: float = 3e-5
    betas: List[float] = field(default_factory=lambda: [0.9, 0.999])
    eps: float = 1e-8


@dataclass
class StructureKwargs:
    exist: List[int] = field(default_factory=lambda: [1] * 9)
    observed: List[int] = field(default_factory=lambda: [0, 0, 0, 1, 1, 1, 1, 1, 1])


@dataclass
class SamplerKwargs:
    class_name: str = "training.sampler.JumpSampler"
    dt: float = 0.001
    do_jump_back: bool = False
    corrector_start_time: float = 0.1
    corrector_steps: int = 0
    corrector_finish_time: float = 0.003
    dt_schedule: str = "uniform"
    dt_schedule_h: float = 0.001
    condition_type: str = "sweep"
    do_jump_corrector: bool = False
    guidance_weight: float = 1.0
    dt_schedule_tc: float = 0.5
    condition_sweep_idx: int = 0
    sample_near_atom: bool = True
    do_conditioning: bool = False
    condition_sweep_path: Optional[str] = None
    dt_schedule_l: float = 0.001
    corrector_snr: float = 0.1
    jump_back_start_time: float = 0.5
    no_noise_final_step: bool = False
    clip_lats: Optional[float] = None
    multi_birth: int = 16
    exact_rate_integral: bool = True
    analytic_dim1_posterior: bool = True
    analytic_posterior_all_dims: bool = True
    analytic_prior_smoothing_sigma: float = 0.0


@dataclass
class GradConditionerKwargs:
    class_name: str = "training.grad_conditioning.MoleculeJump"
    grad_norm_clip: float = 1.0
    lr_rampup_kimg: int = 320


@dataclass
class TransdimEncoderConfig:
    name: str = "TransdimensionalEPiC"
    num_blocks: int = 2
    embedding_time: str = "SinusoidalPositionalEncoding"
    embedding_features_continuous: str = "Linear"
    embedding_features_discrete: str = "Linear"
    embedding_context_continuous: Optional[str] = None
    embedding_context_discrete: Optional[str] = None
    dim_hidden_local: int = 16
    dim_hidden_glob: int = 19
    dim_emb_time: int = 16
    dim_emb_features_continuous: int = 16
    dim_emb_features_discrete: int = 16
    dim_emb_context_continuous: int = 0
    dim_emb_context_discrete: int = 0
    skip_connection: bool = True
    dropout: float = 0.1
    activation: str = "SELU"
    add_discrete_head: bool = True

    rate_use_x0_pred: bool = True
    transformer_dim: int = 128
    n_heads: int = 2
    n_attn_blocks: int = 2
    detach_last_layer: bool = True
    augment_dim: int = 9


@dataclass
class AugmentKwargs:
    class_name: str = "training.augment.AugmentPipe"
    p: float = 0.12
    xflip: float = 1e8
    yflip: int = 1
    scale: int = 1
    rotate_frac: int = 1
    aniso: int = 1
    translate_frac: int = 1


@dataclass
class TransdimensionalEpicConfig:
    """Config tree of the transdimensional family
    (transdimensional_unconditional_config.py:245-331). `device` and the
    tick/snapshot fields mirror the JAX tree and are not read by the port."""

    data: TransdimJetsDataConfig = field(default_factory=TransdimJetsDataConfig)
    encoder: TransdimEncoderConfig = field(default_factory=TransdimEncoderConfig)

    loss_kwargs: LossKwargs = field(default_factory=LossKwargs)
    optimizer_kwargs: OptimizerKwargs = field(default_factory=OptimizerKwargs)
    structure_kwargs: StructureKwargs = field(default_factory=StructureKwargs)
    sampler_kwargs: SamplerKwargs = field(default_factory=SamplerKwargs)
    grad_conditioner_kwargs: GradConditionerKwargs = field(
        default_factory=GradConditionerKwargs
    )
    augment_kwargs: AugmentKwargs = field(default_factory=AugmentKwargs)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    just_visualize: bool = False
    distributed: bool = False
    device: str = "tpu"

    total_kimg: int = 200000
    ema_halflife_kimg: int = 500
    batch_size: int = 64
    batch_gpu: Optional[int] = None
    loss_scaling: float = 1.0
    cudnn_benchmark: bool = True
    kimg_per_tick: int = 50
    snapshot_ticks: int = 25
    state_dump_ticks: int = 25
    log_img_ticks: int = 50
    seed: int = 2047813205
    run_dir: str = ""

    @staticmethod
    def from_yaml(file_path: str) -> "TransdimensionalEpicConfig":
        import yaml

        with open(file_path, "r") as f:
            return TransdimensionalEpicConfig.from_dict(yaml.safe_load(f))

    @staticmethod
    def from_dict(data: dict) -> "TransdimensionalEpicConfig":
        """Build from a nested dict (a YAML file, or the JAX config's
        `to_dict()`); unknown sections and keys are ignored."""
        kwargs = {}
        for f in fields(TransdimensionalEpicConfig):
            if is_dataclass(f.default_factory):
                kwargs[f.name] = _build(f.default_factory, data.get(f.name, {}))
            elif f.name in data:
                kwargs[f.name] = data[f.name]
        return TransdimensionalEpicConfig(**kwargs)

    def to_yaml(self, file_path: str):
        import yaml

        with open(file_path, "w") as f:
            yaml.safe_dump(asdict(self), f, default_flow_style=False)

    def to_dict(self) -> dict:
        return asdict(self)


def _build(cls, d: dict):
    known = set(cls.__dataclass_fields__)
    return cls(**{k: v for k, v in d.items() if k in known})
