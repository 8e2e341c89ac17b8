"""Typed config with the reference's YAML surface and precedence semantics.

The port's own copy of ``objectdetectionpl_tpu/config.py``: same fields, same
defaults, same section-order override rule (later YAML sections override
earlier keys), so one YAML file drives either package.

Per-model image size defaults: RetinaNet 600, SSD 300, YOLOv5 640, else 416.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import yaml


@dataclasses.dataclass
class Config:
    # data section
    data_module: str = "Synthetic"
    data_root: str = "data"
    batch_size: int = 2
    stage: str = "fit"
    test: bool = True
    view_mark: bool = False
    img_size: int = 0                 # 0 -> per-model default
    max_boxes: int = 100              # padded-target capacity
    num_workers: int = 0
    letterbox: bool = False
    mosaic: float = 0.0
    cache_dir: str = ""

    # model section
    model_name: str = "YOLOv5"
    type: str = "Yolov5s"             # YOLOv5 variant
    cls_criterion: str = "bce_loss"
    coord_criterion: str = "smooth_l1_loss"

    # optimizer section
    optimizer: str = "Adam"
    lr: float = 1e-3
    lr_decay: float = 0.0
    lr_scheduler: str = "ReduceLROnPlateau"
    patience: int = 3
    threshold: float = 0.9
    momentum: float = 0.9
    weight_decay: float = 1e-5
    alpha: float = 0.95
    betas: Sequence[float] = (0.9, 0.999)

    # training section
    max_epochs: int = 100
    n_epochs: int = 100
    accumulate_grad_batches: int = 8
    limit_train_batches: Optional[int] = None
    limit_val_batches: Optional[int] = None
    limit_test_batches: Optional[int] = None

    # trainer section
    num_sanity_val_steps: int = 0
    early_stop_patience: int = 3
    save_top_k: int = 3
    log_dir: str = "log_dir"

    # fitune section
    tune: bool = False
    auto_lr_find: bool = True
    auto_scale_batch_size: str = "power"

    torch_ckpt: str = ""

    compute_dtype: str = "float32"    # "bfloat16" for tensor-core compute
    remat: str = "none"
    ema_decay: float = 0.0
    profile_steps: int = 0
    nan_check: bool = True
    histogram_every: int = 1
    log_every_steps: int = 50
    prefetch_batches: int = 2
    v3_double_stride: bool = False
    ssd_bn: bool = False
    conf_thres: float = 0.5           # NMS confidence threshold (YOLO families)
    nms_thres: float = 0.4            # NMS IoU threshold (YOLO families)
    nms_top_k: int = 300              # NMS candidate pool
    mesh_shape: Optional[Sequence[int]] = None
    seed: int = 0
    synthetic_size: int = 64

    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def effective_img_size(self) -> int:
        # SSD's default-box ladder is derived from a 300px input, so SSD is
        # always 300; the other families honor an explicit img_size.
        if self.model_name == "SSD":
            return 300
        if self.img_size:
            return self.img_size
        from objectdetectionpl_tpu_torch.models.registry import \
            default_img_size
        return default_img_size(self.model_name)


def load_config(path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Config:
    """YAML -> Config.  Sections are flattened in file order; later sections
    override earlier keys.  Unknown keys are kept in ``extra``."""
    flat: Dict[str, Any] = {}
    if path:
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        for _, section in raw.items():
            if isinstance(section, dict):
                flat.update(section)
    if overrides:
        flat.update(overrides)

    fields = {f.name for f in dataclasses.fields(Config)}
    known = {k: v for k, v in flat.items() if k in fields and k != "extra"}
    extra = {k: v for k, v in flat.items() if k not in fields}
    return Config(**known, extra=extra)
