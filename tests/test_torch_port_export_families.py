"""Each of the six families through the serving export, and the repair
of the per-device tables that a trace used to fill.

In a fresh interpreter, so that the export's trace is the first call that
reaches the per-device tables (the YOLO anchors, SSD's default boxes,
RetinaNet's anchors and its FPN resize matrices): ``torch.export.export``
of ``build_inference_fn``'s module (YOLOv2/v3/v4/v5 at 64 px, RetinaNet at
128, SSD at 300; 3 classes, random weights from seed 0, B=1); then the
eager module must return real tensors equal, bit for bit, to a chain made
after every cache was emptied, and the program saved and loaded
(``utils/export.py``) the same.  When those caches kept whatever call
filled them first (``train/step.py::_on_device``,
``nn/blocks.py::_resize_matrix`` as an ``lru_cache``), the eager call
after the trace returned the trace's fake tensors, and ``torch.equal`` on
them raised ``DataDependentOutputException`` (ROADMAP §C, C4).
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_FAMILY_PROBE = r"""
import json, sys
import torch
from objectdetectionpl_tpu_torch.models import build_model
from objectdetectionpl_tpu_torch.nn import blocks
from objectdetectionpl_tpu_torch.ops import nms
from objectdetectionpl_tpu_torch.train.step import make_postprocess
from objectdetectionpl_tpu_torch.utils import export

torch.set_num_threads(2)
name, S, path = sys.argv[1], int(sys.argv[2]), sys.argv[3]


def chain():
    model = build_model(name, 3, device="cpu", seed=0)
    post = make_postprocess(name, 3, S, conf_thres=0.3, top_k=32)
    return export.build_inference_fn(model, model.state_dict(), post)


raw = torch.randint(0, 256, (1, S, S, 3), dtype=torch.uint8,
                    generator=torch.Generator().manual_seed(0))
fn = chain()
program = torch.export.export(fn, (raw,))    # the first call: a trace
after = fn(raw)                              # eager, after the trace
real = [type(t).__name__ for t in after]
torch.export.save(program, path)
loaded = export.load(path, "cpu")(raw)
blocks._RESIZE_MATRICES.clear()
nms._ANCHORS.clear()
fresh = chain()(raw)                         # a chain of empty caches
print(json.dumps({
    "types": real, "valid": int(fresh[4].sum()),
    "eager_equal": [torch.equal(a, b) for a, b in zip(after, fresh)],
    "loaded_equal": [torch.equal(a, b) for a, b in zip(loaded, fresh)]}))
"""


@pytest.mark.parametrize("name,img", [
    ("YOLOv2", 64), ("YOLOv3", 64), ("YOLOv4", 64), ("YOLOv5", 64),
    ("RetinaNet", 128), ("SSD", 300)])
def test_export_leaves_the_eager_postprocess_real(tmp_path, name, img):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _FAMILY_PROBE, name, str(img),
         str(tmp_path / "m.pt2")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["types"] == ["Tensor"] * 5
    assert res["eager_equal"] == res["loaded_equal"] == [True] * 5
    assert res["valid"] > 0
