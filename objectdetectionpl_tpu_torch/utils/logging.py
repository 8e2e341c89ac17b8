"""Metric writers: the port of ``objectdetectionpl_tpu/utils/logging.py``.

A JSONL mirror (``metrics.jsonl``, always written) plus TensorBoard through
``torch.utils.tensorboard`` when it imports; without it, scalars still go
to the JSONL file and histograms, images and text are skipped.  Log root
layout: log_dir/<dataset>/<model>.  Under a process group only rank 0
writes: the writers of the other ranks create nothing and drop every
record.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from objectdetectionpl_tpu_torch.parallel import distributed


class MetricWriter:
    """TensorBoard writer (when available) with a JSONL mirror."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._jsonl = None
        self._tb = None
        if distributed.process_index() != 0:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir)

    def scalar(self, tag: str, value: float, step: int):
        if self._jsonl is None:
            return
        if self._tb:
            self._tb.add_scalar(tag, float(value), step)
        self._jsonl.write(json.dumps(
            {"t": time.time(), "tag": tag, "value": float(value),
             "step": int(step)}) + "\n")

    def scalars(self, prefix: str, values: Dict[str, float], step: int):
        for k, v in values.items():
            self.scalar(f"{prefix}/{k}", v, step)

    def histogram(self, tag: str, values, step: int):
        """``values``: an array or a tensor (copied to the host only when
        TensorBoard is there to take it)."""
        if self._tb:
            if torch.is_tensor(values):
                values = values.detach().float().cpu().numpy()
            self._tb.add_histogram(tag, np.asarray(values), step)

    def image(self, tag: str, img_hwc: np.ndarray, step: int):
        if self._tb:
            self._tb.add_image(tag, np.asarray(img_hwc), step,
                               dataformats="HWC")

    def text(self, tag: str, content: str, step: int = 0):
        if self._tb:
            self._tb.add_text(tag, f"```\n{content}\n```", step)

    def flush(self):
        if self._jsonl is not None:
            self._jsonl.flush()
        if self._tb:
            self._tb.flush()

    def close(self):
        self.flush()
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb:
            self._tb.close()


def log_param_histograms(writer: MetricWriter, model: torch.nn.Module,
                         step: int, max_tensors: Optional[int] = None):
    """One histogram per parameter, over ``named_parameters()``."""
    named = list(model.named_parameters())
    for name, p in named[:max_tensors] if max_tensors else named:
        writer.histogram(name, p, step)
