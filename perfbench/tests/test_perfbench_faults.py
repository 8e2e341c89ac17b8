"""A whole run on the CPU at a tiny size, with the look for a card
skipped: sound, it reads ``correct``; with the timed path broken under
it in each way the cell can break, it reads not correct.  And the
control, the reference in float8 in the program's place, reads above
the program."""

import json

import pytest
import torch

from perfbench import run
from perfbench.harness import serve, train
from perfbench.reference.layers import Numerics
from perfbench.tests.conftest import CPU


def result(capsys, cell, seed=7, seconds=0.5, trace=0):
    rc = run.main(["--workload", cell["workload"]["name"], "--seed",
                   str(seed), "--seconds", str(seconds), "--trace",
                   str(trace)], device=CPU, cell=cell)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    return out


def train_cell(tiny, name):
    return tiny(name, compute_dtype="float32")


@pytest.mark.parametrize("name", ["yolov5s-serve-b64", "yolov5s-train-b64",
                                  "retinanet-train-b32"])
def test_sound_run_is_correct(tiny, capsys, name):
    cell = (tiny(name) if name.startswith("yolov5s-serve")
            else train_cell(tiny, name))
    out = result(capsys, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0


def test_an_altered_answer_is_not_correct(tiny, capsys, monkeypatch):
    from objectdetectionpl_tpu_torch.ops import nms
    real = nms.yolo_nms

    def altered(*args, **kw):
        res = real(*args, **kw)
        valid = res.valid.clone()
        valid[0, 0] = ~valid[0, 0]
        return res._replace(valid=valid)
    monkeypatch.setattr(nms, "yolo_nms", altered)
    out = result(capsys, tiny("yolov5s-serve-b64"))
    assert not out["correct"]
    assert out["checks"]["post_rows_differ"]["value"] >= 1


@pytest.mark.parametrize("name", ["yolov5s-train-b64", "retinanet-train-b32"])
def test_a_step_that_leaves_the_state_is_not_correct(tiny, capsys,
                                                     monkeypatch, name):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    out = result(capsys, train_cell(tiny, name))
    assert not out["correct"]
    assert out["checks"]["change_gap_worst"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["yolov5s-train-b64", "retinanet-train-b32"])
def test_half_the_batch_left_out_is_not_correct(tiny, capsys, monkeypatch,
                                                name):
    from objectdetectionpl_tpu_torch.train import step as step_lib
    real = step_lib.make_train_step

    def half(*args, **kw):
        step = real(*args, **kw)

        def first_half(state, images, labels, boxes, mask, weights=None):
            n = images.shape[1] // 2
            return step(state, images[:, :n], labels[:, :n], boxes[:, :n],
                        mask[:, :n], weights)
        return first_half
    monkeypatch.setattr(step_lib, "make_train_step", half)
    out = result(capsys, train_cell(tiny, name, ), seed=11)
    assert not out["correct"]


def test_serving_control_reads_above_the_program(tiny):
    cell = tiny("yolov5s-serve-b64")
    r = serve.ServeRun(cell, 5, CPU, traced=False)
    w = serve.serving_weights(r.reference, r.cfg, r.tr, 5, CPU)
    images = serve.traffic.image_pool(5, 1, 2, 64, CPU)[0]
    maps = {}
    for name in ("float32", "fp8"):
        model = r.reference.build(r.cfg, Numerics(name)).eval()
        model.load_state_dict(w)
        maps[name] = r.reference.forward_blocks(model, images, 2)
    gap = max(float((q - f).norm() / f.norm())
              for q, f in zip(maps["fp8"], maps["float32"]))
    r.setup()
    r.window(0.3)
    r.release()
    assert gap > 3 * r.check()["heads_rel_rms"]
    assert gap > cell["limits"]["heads_rel_rms"]


@pytest.mark.parametrize("name,img", [("yolov5s-train-b64", 256),
                                      ("retinanet-train-b32", 128)])
def test_training_control_reads_above_the_program(tiny, name, img):
    # below these sizes a bfloat16 step reads as far off as the control
    r = train.TrainRun(tiny(name, img=img, batch=4), 5, CPU, traced=False)
    r.setup()
    got = r.program_readings()
    r.release()
    want = r.reference_steps()
    control = train.compare(r.reference_steps(Numerics("fp8")), want)
    assert control["loss_gap_first"] > 3 * train.compare(
        got, want)["loss_gap_first"]


def test_calibration_judges_each_reading(capsys):
    from perfbench import calibrate
    limits = {"heads_rel_rms": 0.02, "post_rows_differ": 0.0}
    calibrate.WRONG.clear()
    sound = {"heads_rel_rms": 0.004, "post_rows_differ": 0.0}
    calibrate.emit(limits, "program", sound, seed=1)
    calibrate.emit(limits, "control", {"heads_rel_rms": 0.06}, seed=1)
    calibrate.emit(limits, "look_fp8_compute", {"heads_rel_rms": 0.004},
                   seed=1)
    assert calibrate.WRONG == []
    calibrate.emit(limits, "control", {"heads_rel_rms": 0.004}, seed=2)
    calibrate.emit(limits, "program", {"heads_rel_rms": 0.004}, seed=3)
    assert calibrate.WRONG == [("control", 2), ("program", 3)]
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines()]
    assert [r["correct"] for r in lines] == [True, False, True, True, False]
    calibrate.WRONG.clear()
