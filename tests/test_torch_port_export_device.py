"""``utils/export.py::load(path, device)``: a ``.pt2`` moved to the device
the port's rule gives, whatever device it was exported on.

- A CPU export of YOLOv5 at 64 px (the /255 folded) and of SSD (anchor
  tables among its constants) loaded with ``device="meta"``: every
  parameter, buffer and lifted constant of the program, every ``device=``
  argument of its nodes and every node's output names the target.  The
  card is not here, so "meta" stands for another device; ``chip_smoke.py
  export`` moves programs between the CPU and the card.
- The CPU reload's detections equal the eager chain's, and the NMS op in
  it runs its plain version (counted).
- ``load`` without a device follows ``resolve_device``: CUDA, which is
  absent here, so it raises.
- ``cli.predict --program F --device cpu`` serves the images through the
  loaded program: records equal to the eager serving chain's.
"""

import os

import pytest
import torch

from objectdetectionpl_tpu_torch.cli import predict
from objectdetectionpl_tpu_torch.config import load_config
from objectdetectionpl_tpu_torch.models import build_model
from objectdetectionpl_tpu_torch.ops.cuda import nms_kernel
from objectdetectionpl_tpu_torch.tools import fixture_trees
from objectdetectionpl_tpu_torch.train import loop
from objectdetectionpl_tpu_torch.train.step import make_postprocess
from objectdetectionpl_tpu_torch.utils import export as export_lib

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "config.yaml")
C = 3


def _export(tmp_path, name, S):
    model = build_model(name, C, device="cpu", seed=1)
    fn = export_lib.build_inference_fn(model, model.state_dict(),
                                       make_postprocess(name, C, S))
    path = str(tmp_path / f"{name}.pt2")
    export_lib.save(path, fn, batch=2, img_size=S)
    return fn, path


def _devices(program):
    """Every device the program names: tensors of its state and
    constants, ``device=`` arguments, node outputs."""
    out = {t.device for t in program.state_dict.values()}
    out |= {t.device for t in program.constants.values()
            if isinstance(t, torch.Tensor)}
    for node in program.graph.nodes:
        if "device" in node.kwargs:
            out.add(torch.device(node.kwargs["device"]))
        vals = node.meta.get("val")
        for v in vals if isinstance(vals, (list, tuple)) else [vals]:
            if isinstance(v, torch.Tensor):
                out.add(v.device)
    return out


@pytest.mark.parametrize("name,S", [("YOLOv5", 64), ("SSD", 300)])
def test_moved_program_names_only_the_target(tmp_path, name, S):
    _, path = _export(tmp_path, name, S)
    exported = torch.export.load(path)
    assert _devices(exported) == {torch.device("cpu")}
    assert any("device" in n.kwargs for n in exported.graph.nodes)
    assert _devices(export_lib.load_program(path, "meta")) == {
        torch.device("meta")}


def test_cpu_reload_equals_eager(tmp_path, monkeypatch):
    fn, path = _export(tmp_path, "YOLOv5", 64)
    raw = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(3))
    want = fn(raw)
    calls = []
    plain = nms_kernel.greedy_nms_plain
    monkeypatch.setattr(nms_kernel, "greedy_nms_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    got = export_lib.load(path, "cpu")(raw)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and torch.equal(g, w)
    assert calls == [1]


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is present")
def test_load_follows_the_device_rule(tmp_path):
    _, path = _export(tmp_path, "YOLOv5", 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_lib.load(path)


def test_cli_serves_a_saved_program(tmp_path, capsys):
    S = 64
    over = {"model_name": "YOLOv5", "img_size": S, "conf_thres": 0.3,
            "log_dir": str(tmp_path / "logs")}
    sets = [a for k, v in over.items() for a in ("--set", k, str(v))]
    path = str(tmp_path / "m.pt2")
    trainer = loop.Trainer(load_config(YAML, over), device="cpu")
    trainer.ckpt.save(0, trainer.state, 1.0)
    trainer.ckpt.wait()
    trainer.ckpt.close()
    trainer.writer.close()
    predict.main([YAML, *sets, "--device", "cpu", "--export", path])
    images = [str(fixture_trees.TESTDATA / n)
              for n in fixture_trees.decodable()[:3]]
    # the eager serving chain (the /255 folded, as exported) on each image
    eager = export_lib.build_inference_fn(
        trainer.model, {**trainer.model.state_dict(),
                        **trainer.state.eval_params}, trainer.postprocess)
    want = predict.predict_images(trainer, images, program=eager)
    capsys.readouterr()
    got = predict.main([YAML, *sets, "--device", "cpu", "--program", path,
                        "--images", *images])
    assert got == want and len(got) == 3
    assert "restored best checkpoint" not in capsys.readouterr().out
