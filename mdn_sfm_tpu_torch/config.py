"""Configuration — the port's own copy of ``mdn_sfm_tpu.config``.

Same dataclass field names and defaults, so one ``opt.json`` reads in both
packages. The two fields whose behaviour this port does not implement yet
(``steps_per_dispatch > 1``, ``num_data_shards > 1``) raise
``NotImplementedError`` in :meth:`Config.validate`; they are never ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import os
import sys
from dataclasses import dataclass
from typing import Sequence


class Mode(str, enum.Enum):
    """Epipolar-map post-processing / supervision mode.

    SN — normalized + squared epipolar map
    T  — truncated (threshold-divided, squared)
    TG — truncated + gaussian distance-weighted
    DS — instance-mask × epipolar map
    DC — SN post-processing + BCE similarity to the instance-union mask
    """

    SN = "SN"
    T = "T"
    TG = "TG"
    DS = "DS"
    DC = "DC"


@dataclass
class Config:
    """Unified train/eval configuration (field names as in ``mdn_sfm_tpu``)."""

    # PATHS
    data_path: str = "kitti/raw_data"
    data_root: str = "kitti"
    log_dir: str = "log"
    other_files_path: str = "files"

    # TRAINING
    split: str = "eigen_zhou"
    num_layers: int = 18
    use_elu: bool = True
    dataset: str = "kitti"
    png: bool = True
    height: int = 128
    width: int = 416
    w_p: float = 1.0
    w_e: float = 1.0
    w_s: float = 1.0
    w_c: float = 0.5
    w_d2_sim: float = 0.05
    ds_similarity_term: bool = False
    threshold: float = 9.22
    alpha: float = 0.55
    scales: tuple[int, ...] = (0, 1, 2, 3)
    frame_ids: tuple[int, ...] = (0, -1, 1)
    seed: int = 42
    clip_grad: float = 1.0
    skip_nonfinite_updates: bool = False

    mode: Mode = Mode.SN
    gauss_sigma1: float = 30.0
    gauss_sigma2: float = 120.0

    # OPTIMIZATION
    fine_tune_flow_motion: bool = False
    batch_size: int = 4
    learning_rate: float = 1e-4
    num_epochs: int = 20
    momentum: float = 0.9     # adam beta1
    beta: float = 0.999       # adam beta2
    weight_decay: float = 0.0
    scheduler_step_size: float = 0.5
    legacy_lr_schedule: bool = False

    # ABLATION
    no_ssim: bool = True
    weights_init: str = "scratch"
    pose_model_input: str = "pairs"
    disable_photoloss: bool = True
    disable_consisloss: bool = False
    disable_min: bool = False
    disable_smoothloss: bool = False
    disable_augment: bool = False

    # SYSTEM
    num_workers: int = 4
    limit_train_samples: int = 0
    cache_decoded: str = ""

    # LOADING
    models_to_load: tuple[str, ...] = ("flownet", "posenet", "mobile_decoder")
    load_adam: bool = False
    v_load: str = "v0"
    idx_load: int = 0

    # LOGGING
    log_frequency: int = 100
    save_frequency: int = 1000
    v_save: str = "v"

    # EVALUATION
    data_eval_dir: str = "kitti/data_semantics"
    idx_eval: int = 0
    raw_dataset_dir: str = "kitti"
    load_weights_folder: str = "log/v0/models/weights_0"
    version: str = "v3"
    idx: int = 14
    eval_out_dir: str = "output/prediction"
    gt_mask_path: str = "output/mobile_objects_ground_truth"
    eval_name: str = "mobile_masks"
    sequence_length: int = 3
    save_pred_masks: bool = False
    save_pred_motions: bool = False
    save_pred_poses: bool = False
    pred_errors: bool = False
    binary_threshold: float = 0.5
    eval_num_samples: int = 200
    eval_batch_size: int = 8

    # INSTANCE MASKS
    mask_provider: str = "none"
    mask_dir: str = "output/prediction/detectron2/pred_masks"
    d2_score_thresh: float = 0.3
    d2_max_instances: int = 32
    d2_infer_scale: int = 2
    d2_allow_random_weights: bool = False
    d2_fuse_step: bool = True

    # ACCELERATOR knobs
    compute_dtype: str = "bfloat16"   # conv compute dtype; params and losses stay fp32
    use_pallas_epipolar: bool = True  # the JAX package's name: the hand-written
    # epipolar kernel while the maps carry no gradient; False (or
    # fine_tune_flow_motion) takes the plain map with autograd on every device
    num_data_shards: int = 0
    bn_frozen_eval: bool = True
    donate_state: bool = True
    remat: bool = False
    accum_steps: int = 1
    resume: str = ""
    profile_dir: str = ""
    steps_per_dispatch: int = 1

    # ------------------------------------------------------------------ utils

    @property
    def num_scales(self) -> int:
        return len(self.scales)

    @property
    def ref_frame_ids(self) -> tuple[int, ...]:
        """Reference frames (frame_ids without the target 0)."""
        return tuple(i for i in self.frame_ids if i != 0)

    def validate(self) -> "Config":
        if self.height % 32 or self.width % 32:
            raise ValueError("'height' and 'width' must be multiples of 32")
        if self.frame_ids[0] != 0:
            raise ValueError("frame_ids must start with 0")
        self.mode = Mode(self.mode)
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype must be bfloat16 or float32, not {self.compute_dtype!r}")
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, not {self.accum_steps}")
        if self.steps_per_dispatch > 1:
            # several optimizer steps a dispatch: on the card a captured
            # multi-step CUDA graph, not a scan
            raise NotImplementedError(
                f"steps_per_dispatch={self.steps_per_dispatch} is not implemented by the PyTorch port yet "
                "(only the default 1)"
            )
        if self.num_data_shards > 1:
            raise NotImplementedError(
                "num_data_shards > 1 (data parallelism) is not implemented by the PyTorch port yet"
            )
        # DS/DC with the live provider below the reference's shortest-edge-1024
        # inference resolution trains on measurably different union masks:
        # warn once, so a README-comparison run is never silently off-spec
        ref_equiv_scale = 1024 / min(self.height, self.width)
        if (self.mode in (Mode.DS, Mode.DC) and self.mask_provider == "maskrcnn"
                and self.d2_infer_scale < ref_equiv_scale):
            global _WARNED_D2_SCALE
            if not _WARNED_D2_SCALE:
                _WARNED_D2_SCALE = True
                print(
                    f"WARNING: mode={self.mode.value} with the live maskrcnn provider at "
                    f"d2_infer_scale={self.d2_infer_scale} (< reference-equivalent "
                    f"{ref_equiv_scale:.1f} for {self.height}x{self.width}) trains on union masks that "
                    "deviate from the reference's 1024-edge pipeline. For strict DS/DC reproduction "
                    "precompute 1024-edge masks with python -m mdn_sfm_tpu_torch.precompute_masks and "
                    "use mask_provider=precomputed.",
                    file=sys.stderr,
                )
        return self

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["mode"] = self.mode.value
        return json.dumps(d, indent=2)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return _from_dict(json.load(f))


_WARNED_D2_SCALE = False
_TUPLE_FIELDS = ("scales", "frame_ids", "models_to_load")


def _from_dict(d: dict) -> Config:
    known = {f.name for f in dataclasses.fields(Config)}
    d = {k: v for k, v in d.items() if k in known}
    if "mode" in d:
        d["mode"] = Mode(d["mode"])
    for k in _TUPLE_FIELDS:
        if k in d and d[k] is not None:
            d[k] = tuple(d[k])
    return Config(**d).validate()


# --------------------------------------------------------------------- CLI

_BOOL_FLAGS_TRAIN = [
    "fine_tune_flow_motion", "no_ssim", "disable_photoloss", "disable_consisloss",
    "disable_min", "disable_smoothloss", "load_adam", "legacy_lr_schedule",
    "skip_nonfinite_updates", "remat",
]

_TRAIN_FIELDS = [
    "data_path", "data_root", "log_dir", "other_files_path",
    "split", "num_layers", "use_elu", "dataset", "png", "height", "width",
    "w_p", "w_e", "w_s", "w_c", "w_d2_sim", "ds_similarity_term", "threshold", "alpha",
    "scales", "frame_ids", "seed", "clip_grad", "skip_nonfinite_updates", "mode",
    "gauss_sigma1", "gauss_sigma2",
    "fine_tune_flow_motion", "batch_size", "learning_rate", "num_epochs",
    "momentum", "beta", "weight_decay", "scheduler_step_size", "legacy_lr_schedule",
    "no_ssim", "weights_init", "pose_model_input",
    "disable_photoloss", "disable_consisloss", "disable_min", "disable_smoothloss",
    "disable_augment",
    "num_workers", "limit_train_samples", "cache_decoded",
    "models_to_load", "load_adam", "v_load", "idx_load", "resume",
    "log_frequency", "save_frequency", "v_save",
    "mask_provider", "mask_dir", "d2_score_thresh", "d2_max_instances",
    "d2_infer_scale", "d2_fuse_step", "d2_allow_random_weights",
    "compute_dtype", "num_data_shards", "bn_frozen_eval", "profile_dir",
    "steps_per_dispatch", "remat", "accum_steps",
]


_BOOL_FLAGS_EVAL = [
    "save_pred_masks", "save_pred_motions", "save_pred_poses", "pred_errors",
]

_EVAL_FIELDS = [
    "data_root", "log_dir", "raw_dataset_dir", "height", "width",
    "num_layers", "threshold", "alpha", "scales", "batch_size", "num_workers",
    "weights_init", "mode", "gauss_sigma1", "gauss_sigma2", "w_d2_sim",
    "load_weights_folder", "version", "idx", "eval_name", "eval_out_dir",
    "gt_mask_path", "sequence_length", "binary_threshold", "eval_num_samples",
    "eval_batch_size",
    "save_pred_masks", "save_pred_motions", "save_pred_poses", "pred_errors",
    "mask_provider", "mask_dir", "d2_score_thresh", "d2_max_instances",
    "d2_infer_scale", "d2_allow_random_weights", "compute_dtype",
]


def _add_fields(parser: argparse.ArgumentParser, names: Sequence[str], bool_flags: Sequence[str]) -> None:
    default = Config()
    for name in names:
        cur = getattr(default, name)
        if name in bool_flags:
            parser.add_argument(f"--{name}", action="store_true", default=cur)
        elif isinstance(cur, tuple) and cur and isinstance(cur[0], int):
            parser.add_argument(f"--{name}", nargs="+", type=int, default=list(cur))
        elif isinstance(cur, tuple):
            parser.add_argument(f"--{name}", nargs="+", type=str, default=list(cur))
        elif isinstance(cur, Mode):
            parser.add_argument(f"--{name}", type=str, choices=[m.value for m in Mode], default=cur.value)
        elif isinstance(cur, bool):
            parser.add_argument(f"--{name}", type=lambda s: s.lower() in ("1", "true", "yes"), default=cur)
        else:
            parser.add_argument(f"--{name}", type=type(cur), default=cur)


def add_train_args(parser: argparse.ArgumentParser) -> None:
    """The JAX package's train flags, with the same names and defaults."""
    _add_fields(parser, _TRAIN_FIELDS, _BOOL_FLAGS_TRAIN)


def add_eval_args(parser: argparse.ArgumentParser) -> None:
    """The JAX package's eval flags, with the same names and defaults (one
    set of defaults for train and eval, as there)."""
    _add_fields(parser, _EVAL_FIELDS, _BOOL_FLAGS_EVAL)


def from_args(args: argparse.Namespace) -> Config:
    return _from_dict(vars(args))


def parse_train_config(argv: Sequence[str] | None = None) -> Config:
    parser = argparse.ArgumentParser(description="MDN-SfM PyTorch train options")
    add_train_args(parser)
    return from_args(parser.parse_args(argv))


def parse_eval_config(argv: Sequence[str] | None = None) -> Config:
    parser = argparse.ArgumentParser(description="MDN-SfM PyTorch eval options")
    add_eval_args(parser)
    return from_args(parser.parse_args(argv))


def parse_eval_cli(description: str, argv: Sequence[str] | None = None) -> tuple[Config, str]:
    """An eval CLI's (config, device): the eval flags plus ``--device``
    (default ``cuda``)."""
    parser = argparse.ArgumentParser(description=description)
    add_eval_args(parser)
    parser.add_argument("--device", type=str, default="cuda", help="default: cuda")
    args = parser.parse_args(argv)
    return from_args(args), args.device
