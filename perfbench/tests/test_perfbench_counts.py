"""The FLOP counts on the frozen references, the NMS bound (one count for
every K) and the warp bound."""

import json

import pytest
import torch

from perfbench.counts import flops, nms_bound, peaks, warp_bound
from perfbench.harness import manifest
from perfbench.reference import postprocess, retinanet, yolov5

YOLO = json.loads((manifest.BENCH / "configs" / "yolov5s-640.json")
                  .read_text())
RETINA = json.loads((manifest.BENCH / "configs" / "retinanet-r50-fpn-600.json")
                    .read_text())


def test_yolov5s_forward_matches_the_conv_shapes():
    counted = flops.forward_flops(yolov5, YOLO)
    shapes = flops.conv_flops(yolov5, YOLO)
    assert counted == pytest.approx(shapes, rel=0.01)
    # ultralytics' v5.0 README gives 17.0 GFLOPs at 640 for its C3
    # YOLOv5s; the BottleneckCSP model at the same widths is near it
    assert 15.5e9 < counted < 18.5e9


def test_retinanet_forward():
    counted = flops.forward_flops(retinanet, RETINA)
    assert counted == pytest.approx(flops.conv_flops(retinanet, RETINA),
                                    rel=0.01)
    assert 140e9 < counted < 180e9


@pytest.mark.parametrize("cfg,ref", [(YOLO, yolov5), (RETINA, retinanet)],
                         ids=["yolov5s", "retinanet"])
def test_training_counts_forward_and_backward(cfg, ref):
    fwd = flops.forward_flops(ref, cfg)
    assert 2.8 * fwd < flops.train_flops(ref, cfg) < 3.0 * fwd


def test_nms_bound_is_bytes_bound_at_serving_sizes():
    rows = 64 * 300
    t = nms_bound.bound_s(rows, valid=rows, suppressed=rows)
    assert t == pytest.approx(rows * nms_bound.ROW_BYTES
                              / peaks.HBM_BYTES_PER_S)


def segmented_keep(boxes, scores, labels, weight, thresh):
    """The same NMS computed label by label, as the K > 1024 route splits
    it: each label's rows through the scan on their own."""
    keep = torch.zeros(scores.shape, dtype=torch.bool)
    for b in range(scores.shape[0]):
        for lab in labels[b].unique():
            rows = (labels[b] == lab).nonzero()[:, 0]
            _, k = postprocess.greedy_nms(
                boxes[b, rows][None], scores[b, rows][None],
                labels[b, rows][None], weight[b, rows][None], thresh)
            keep[b, rows] = k[0]
    return keep


@pytest.mark.parametrize("K", [300, 1500])
def test_nms_bound_is_the_same_whichever_route(K):
    g = torch.Generator().manual_seed(K)
    xy = torch.rand(2, K, 2, generator=g) * 600
    wh = 20 + torch.rand(2, K, 2, generator=g) * 80
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.sort(torch.rand(2, K, generator=g), descending=True)[0]
    scores[:, K // 2:] = postprocess.NEG_INF       # half the rows invalid
    labels = torch.randint(0, 5, (2, K), generator=g, dtype=torch.int32)
    weight = torch.rand(2, K, generator=g)
    _, one_scan = postprocess.greedy_nms(boxes, scores, labels, weight, 0.4)
    by_label = segmented_keep(boxes, scores, labels, weight, 0.4)
    assert torch.equal(one_scan, by_label)
    valid = int((scores > postprocess.NEG_INF).sum())

    def bound(keep):
        return nms_bound.bound_s(2 * K, valid, valid - int(keep.sum()))
    assert bound(one_scan) == bound(by_label)


def test_warp_bound():
    ident = torch.eye(3)[None]
    assert warp_bound.inside_pixels(64, 48, ident) == 64 * 48
    outside = torch.tensor([[[1.0, 0, 5.0], [0, 1.0, 0], [0, 0, 1.0]]])
    assert warp_bound.inside_pixels(64, 48, outside) == 0
    K, H, W, C = 26, 640, 640, 3
    t = warp_bound.bound_s(K, H, W, C, ident.repeat(5, 1, 1))
    nbytes = 2 * K * H * W * C * 4 + K * 9 * 4 + K
    assert t == pytest.approx(nbytes / peaks.HBM_BYTES_PER_S)
