"""Typed configuration: the port's own copies of frtm_tpu's DiscConfig,
TrackerConfig, eval_aug_params, autodetect_arch and eval_config (the
reference evaluate.py settings). Values are identical; only the import graph
differs."""
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class DiscConfig:
    """Static hyper-parameters of the online target model (eval settings)."""
    in_channels: int = 1024
    c_channels: int = 96
    out_channels: int = 1
    init_iters: Tuple[int, ...] = (5, 10, 10, 10, 10)
    update_iters: Tuple[int, ...] = (10,)
    filter_reg: Tuple[float, ...] = (1e-4, 1e-2)
    precond: Tuple[float, ...] = (1e-4, 1e-2)
    precond_lr: float = 0.1
    cg_forgetting_rate: float = 750
    memory_size: int = 80
    train_skipping: int = 8
    learning_rate: float = 0.1
    update_filters: bool = True
    pixel_weighting_method: str = "hinge"   # 'none'|'fixed'|'hinge'|'first-frame'
    pixel_weighting_tf: float = 0.1
    pixel_weighting_per_frame: bool = True
    distractor_mult: float = 1.0
    update_method: str = "frtm"
    clamp_output: bool = False
    solver: str = "stencil"
    layer: str = "layer4"

    @property
    def direction_forget_factor(self) -> float:
        return (1.0 - self.precond_lr) ** self.cg_forgetting_rate


def eval_aug_params(num_aug: int = 5) -> dict:
    """Eval-time augmentation parameter selections."""
    return dict(
        num_aug=num_aug,
        min_px_count=1,
        fg_aug_params=dict(
            rotation=[5, -5, 10, -10, 20, -20, 30, -30, 45, -45],
            fliplr=[False, False, False, False, True],
            scale=[0.5, 0.7, 1.0, 1.5, 2.0, 2.5],
            skew=[(0.0, 0.0), (0.0, 0.0), (0.1, 0.1)],
            blur_size=[0.0, 0.0, 0.0, 2.0],
            blur_angle=[0, 45, 90, 135],
        ),
        bg_aug_params=dict(
            location=[(0.5, 0.5)],
            rotation=[0, 0, 0],
            fliplr=[False],
            scale=[1.0, 1.0, 1.2],
            skew=[(0.0, 0.0)],
            blur_size=[0.0, 0.0, 1.0, 2.0, 5.0],
            blur_angle=[0, 45, 90, 135],
        ),
    )


@dataclass(frozen=True)
class TrackerConfig:
    """Inference configuration (single-layer target model)."""
    feature_extractor: str = "resnet101"
    num_aug: int = 5
    disc: DiscConfig = field(default_factory=DiscConfig)
    refnet_layers: Tuple[str, ...] = ("layer5", "layer4", "layer3", "layer2")
    refnet_channels: int = 64
    refnet_use_bn: bool = True
    aug_params: dict = field(default_factory=eval_aug_params)
    # 'float32' or 'bfloat16': the type the backbone (both trackers) and the
    # decoder (the fused tracker) compute in; target model, solver, memory
    # and merge are float32 either way
    compute_dtype: str = "float32"
    # one target model per named layer; () = single-layer via disc.layer,
    # the only form the port's trackers take so far
    disc_layers: Tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "aug_params", dict(self.aug_params))


COMPUTE_DTYPES = ("float32", "bfloat16")


def compute_dtype_of(cfg: "TrackerConfig"):
    """cfg.compute_dtype as a torch dtype; raises on any other name."""
    import torch
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of {COMPUTE_DTYPES}")
    return getattr(torch, cfg.compute_dtype)


def autodetect_arch(refiner_state_dict) -> str:
    """The backbone, from the input width of the refiner checkpoint's layer4
    reduce conv ('refiner.TSE.layer4.reduce.0.weight', (O, I, kh, kw))."""
    in_channels = refiner_state_dict["refiner.TSE.layer4.reduce.0.weight"].shape[1]
    if in_channels == 1024:
        return "resnet101"
    if in_channels == 256:
        return "resnet18"
    raise ValueError(f"Cannot autodetect backbone from {in_channels} input channels")


def eval_config(arch: str, fast: bool = False, num_aug: int = 5,
                compute_dtype: str = "float32") -> TrackerConfig:
    """The reference eval settings; `fast` selects the (5,10,10,10)/(5,)
    schedule."""
    from .models.resnet import resnet_out_channels

    disc = DiscConfig(
        in_channels=resnet_out_channels(arch)["layer4"],
        c_channels=96,
        out_channels=1,
        init_iters=(5, 10, 10, 10) if fast else (5, 10, 10, 10, 10),
        update_iters=(5,) if fast else (10,),
        memory_size=80,
        train_skipping=8,
        learning_rate=0.1,
        filter_reg=(1e-4, 1e-2),
        precond=(1e-4, 1e-2),
        precond_lr=0.1,
        cg_forgetting_rate=750,
        pixel_weighting_method="hinge",
        pixel_weighting_tf=0.1,
        layer="layer4",
    )
    return TrackerConfig(feature_extractor=arch, num_aug=num_aug, disc=disc,
                         aug_params=eval_aug_params(num_aug), compute_dtype=compute_dtype)
