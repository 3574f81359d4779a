"""Typed configs, YAML-compatible with the reference's 4_Experiments/configs.

Port of ``eyegaze_tpu/config.py``: the same nested dataclasses, fields and
defaults (but ``SystemConfig.device``, which names a torch device and
defaults to ``"cuda"``), so one YAML file configures either package.

PyYAML is imported only by ``load_yaml_config`` and ``save_yaml_config``;
building a config from the dataclasses or from a dict needs no YAML.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Dict, Optional


def _from_dict(cls, d: Dict[str, Any]):
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in (d or {}).items() if k in fields})


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError("reading or writing a YAML config needs PyYAML (pip install pyyaml); "
                           "build the config from the dataclasses or config_from_dict "
                           "instead") from e
    return yaml


@dataclasses.dataclass
class AblationConfig:
    use_spectrogram: bool = True
    use_ibs: bool = True
    ibs_mode: str = "robust"  # 'robust' | 'scalar'
    ibs_instance_norm: bool = True
    ibs_feature_type: str = "all"  # 'all' | 'phase' | 'amplitude'
    use_cross_attention: bool = True


@dataclasses.dataclass
class ModelConfig:
    in_channels: int = 32
    num_labels: int = 3
    d_model: int = 256
    num_layers: int = 6
    num_heads: int = 8
    d_ff: int = 1024
    conv_kernel_size: int = 25
    conv_stride: int = 4
    conv_layers: int = 2
    spec_n_fft: int = 128
    spec_hop_length: int = 64
    spec_freq_bins: int = 64
    # gaze/vit fields
    model_name: str = "vit_base_patch16_224"
    fusion_mode: str = "concat"
    pretrained: bool = False
    pretrained_path: Optional[str] = None
    img_size: int = 224
    # fuzzy fusion
    fuzzy_mode: str = "full"


@dataclasses.dataclass
class DataConfig:
    metadata_path: str = ""
    eeg_base_path: str = ""
    image_base_path: str = ""
    train_test_split: float = 0.2
    random_seed: int = 42
    max_samples: Optional[int] = None
    window_size: int = 1024
    stride: int = 512
    sampling_rate: float = 256.0
    filter_low: float = 1.0
    filter_high: float = 45.0
    enable_preprocessing: bool = False
    class_names: tuple = ("Single", "Competition", "Cooperation")
    val_pairs: tuple = (33, 34, 35, 36, 37, 38, 39, 40)
    synthetic: bool = False  # use synthetic fixtures when real data is absent
    synthetic_trials: int = 96


@dataclasses.dataclass
class TrainingConfig:
    output_dir: str = "runs/default"
    num_train_epochs: int = 50
    per_device_train_batch_size: int = 128
    per_device_eval_batch_size: int = 128
    learning_rate: float = 1e-4
    encoder_learning_rate: Optional[float] = None  # multimodal two-LR setup
    weight_decay: float = 0.01
    dropout: float = 0.1
    warmup_epochs: float = 0.0
    grad_clip: float = 1.0
    bf16: bool = True
    scheduler: str = "cosine_epoch"  # 'cosine_epoch' | 'warmup_cosine_step' | 'constant'
    # loss toggles + weights (train_art.py / dual_eeg_transformer.yaml parity)
    use_sym_loss: bool = False
    use_ibs_loss: bool = False
    use_ibs_cls_loss: bool = True
    use_ibs_contrastive: bool = False
    lambda_sym: float = 0.1
    lambda_ibs: float = 0.1
    lambda_ibs_cls: float = 1.0
    lambda_ibs_contrastive: float = 0.3
    use_class_weights: bool = False
    # multimodal loss weights (train_multimodal_fuzzy_fusion.py:440-460)
    lambda_img: float = 0.3
    lambda_eeg: float = 0.3
    lambda_temp_reg: float = 0.1
    freeze_encoders: bool = False
    save_every_n_epochs: int = 10
    metric_for_best_model: str = "f1"
    greater_is_better: bool = True
    logging_steps: int = 10


@dataclasses.dataclass
class SystemConfig:
    seed: int = 42
    # A torch device name.  The reference YAML's accelerator names ("tpu",
    # "gpu") mean the CUDA card to the port's entry points.
    device: str = "cuda"
    num_workers: int = 0
    # The device-mesh spec ('dp', 'dpN', 'tpN', 'dpN,tpM'): the entry points
    # train over it (eyegaze_tpu_torch.parallel).
    mesh: Any = False


@dataclasses.dataclass
class WandbConfig:
    project: str = "Multimodal_EEG"
    run_name: str = "run"
    tags: tuple = ()
    notes: str = ""
    entity: Optional[str] = None
    enabled: bool = False


@dataclasses.dataclass
class ExperimentConfig:
    ablation: AblationConfig = dataclasses.field(default_factory=AblationConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    system: SystemConfig = dataclasses.field(default_factory=SystemConfig)
    wandb: WandbConfig = dataclasses.field(default_factory=WandbConfig)
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("raw", None)
        return d


def load_yaml_config(path: str | pathlib.Path) -> ExperimentConfig:
    with open(path) as f:
        raw = _yaml().safe_load(f) or {}
    return config_from_dict(raw)


def config_from_dict(raw: Dict[str, Any]) -> ExperimentConfig:
    return ExperimentConfig(
        ablation=_from_dict(AblationConfig, raw.get("ablation", {})),
        model=_from_dict(ModelConfig, raw.get("model", {})),
        data=_from_dict(DataConfig, raw.get("data", {})),
        training=_from_dict(TrainingConfig, raw.get("training", {})),
        system=_from_dict(SystemConfig, raw.get("system", {})),
        wandb=_from_dict(WandbConfig, raw.get("wandb", {})),
        raw=raw,
    )


def save_yaml_config(cfg: ExperimentConfig, path: str | pathlib.Path):
    yaml = _yaml()
    with open(path, "w") as f:
        yaml.safe_dump(cfg.raw or cfg.to_dict(), f, sort_keys=False)
