"""The port against the frozen references at a tiny size on the CPU, in
float32 and in the configurations' bfloat16: what a run's check compares
reads near 0 where the arithmetic is the same."""

import torch

from perfbench.harness import serve, train
from perfbench.tests.conftest import CPU


def test_serving_chain_matches_the_reference(tiny):
    run = serve.ServeRun(tiny("yolov5s-serve-b64"), 5, CPU, traced=False)
    run.setup()
    run.window(0.5)
    run.release()
    got = run.check()
    assert got["heads_rel_rms"] < 0.01                # bf16 against f32
    assert got["post_rows_differ"] == 0 and got["post_box_err_px"] < 1e-3


def test_training_step_matches_the_reference_in_float32(tiny):
    for name in ("yolov5s-train-b64", "retinanet-train-b32"):
        run = train.TrainRun(tiny(name, compute_dtype="float32"), 3, CPU,
                             traced=False)
        run.setup()
        run.release()
        got = run.check()
        assert got["loss_gap_first"] < 1e-5, name
        assert got["grad_gap_median"] < 1e-4, name
        assert got["change_gap_worst"] < 0.05, name


def test_reference_augmentation_is_the_ports(tiny):
    from objectdetectionpl_tpu_torch.data import augment
    from perfbench.harness import traffic
    from perfbench.reference import augment as ref
    cell = tiny("yolov5s-train-b64", img=96, batch=8)
    cfg = cell["config"]["augment"]
    labels, boxes, mask = traffic.targets(2, 1, 8, 96,
                                          cell["traffic"]["targets"], 80)
    x = traffic.image_pool(2, 1, 8, 96, "cpu")[0].float() / 255
    u = traffic.uniforms(2, 1, 8, "cpu")[0]
    u[:, 2] = torch.linspace(0.0, 0.3, 8)           # several warps applied
    got = augment.augment_batch(x.clone(), boxes[0], mask[0],
                                augment.AugmentConfig(**cfg), u=u)
    want = ref.augment(x.clone(), boxes[0], mask[0], u, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
