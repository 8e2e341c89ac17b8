"""Import hygiene, the device rule and the config copy of the port.

The port and ``chip_smoke.py`` must import no jax, flax or optax, nothing
of ``objectdetectionpl_tpu``, neither cv2 nor PIL (the port decodes
JPEGs and writes PNGs itself), and no psutil (absent on the card's
machine; the tuner reads ``/proc/meminfo``) -- checked in a fresh interpreter, since this
test process has JAX loaded for the parity tests.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from objectdetectionpl_tpu.config import Config as JaxConfig
from objectdetectionpl_tpu.config import load_config as jax_load_config
from objectdetectionpl_tpu_torch.config import Config, load_config
from objectdetectionpl_tpu_torch.device import resolve_device
from objectdetectionpl_tpu_torch.models import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import objectdetectionpl_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cv2",
                                    "PIL", "psutil")
             or k == "objectdetectionpl_tpu"
             or k.startswith("objectdetectionpl_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert "objectdetectionpl_tpu_torch.ops.cuda.nms_kernel" in res["modules"]
    assert {"objectdetectionpl_tpu_torch.ops.yolo_stats",
            "objectdetectionpl_tpu_torch.models.yolov4",
            "objectdetectionpl_tpu_torch.models.retinanet",
            "objectdetectionpl_tpu_torch.models.ssd",
            "objectdetectionpl_tpu_torch.data.parsers",
            "objectdetectionpl_tpu_torch.data.parsers.common",
            "objectdetectionpl_tpu_torch.data.parsers.pascal",
            "objectdetectionpl_tpu_torch.data.parsers.coco",
            "objectdetectionpl_tpu_torch.data.parsers.bdd100k",
            "objectdetectionpl_tpu_torch.data.parsers.widerperson",
            "objectdetectionpl_tpu_torch.data.parsers.container",
            "objectdetectionpl_tpu_torch.data.parsers.asiatraffic",
            "objectdetectionpl_tpu_torch.data.cache",
            "objectdetectionpl_tpu_torch.data.formats",
            "objectdetectionpl_tpu_torch.cli.predict",
            "objectdetectionpl_tpu_torch.utils.export",
            "objectdetectionpl_tpu_torch.bench",
            "objectdetectionpl_tpu_torch.train.tune",
            "objectdetectionpl_tpu_torch.tools.fixture_trees",
            "objectdetectionpl_tpu_torch.parallel",
            "objectdetectionpl_tpu_torch.parallel.distributed",
            "objectdetectionpl_tpu_torch.parallel.mesh",
            "objectdetectionpl_tpu_torch.parallel.dryrun"} <= set(
                res["modules"])
    assert len(res["modules"]) >= 15


def test_device_rule():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model("YOLOv5", 3)
    assert resolve_device("cpu") == torch.device("cpu")
    model = build_model("YOLOv5", 3, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert not model.training


def test_build_model_is_seeded():
    a = build_model("YOLOv5", 3, device="cpu", seed=7).state_dict()
    b = build_model("YOLOv5", 3, device="cpu", seed=7).state_dict()
    c = build_model("YOLOv5", 3, device="cpu", seed=8).state_dict()
    key = "BottleneckCSP_0.Conv_1.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])


@pytest.mark.parametrize("model_name,img_size,want", [
    ("YOLOv5", 0, 640), ("YOLOv3", 0, 416), ("RetinaNet", 0, 600),
    ("SSD", 512, 300), ("YOLOv5", 320, 320)])
def test_config_matches_jax(model_name, img_size, want):
    port = Config(model_name=model_name, img_size=img_size)
    ref = JaxConfig(model_name=model_name, img_size=img_size)
    assert port.effective_img_size == ref.effective_img_size == want


def test_load_config_matches_jax(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("data:\n  batch_size: 8\n  img_size: 320\n"
                    "model:\n  model_name: YOLOv5\n  type: Yolov5m\n"
                    "yaml_test:\n  batch_size: 4\n  unknown_key: 1\n")
    port = load_config(str(path), {"conf_thres": 0.25})
    ref = jax_load_config(str(path), {"conf_thres": 0.25})
    fields = [f for f in vars(ref)]
    assert {f: getattr(port, f) for f in fields} == vars(ref)
    assert port.batch_size == 4 and port.extra == {"unknown_key": 1}
    assert json.dumps(sorted(vars(port))) == json.dumps(sorted(vars(ref)))
