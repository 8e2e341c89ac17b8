"""The one traffic generator: the same seed gives the same inputs, two
seeds give different ones, and the targets keep to the traffic file."""

import json

import numpy as np
import pytest
import torch

from perfbench.harness import manifest, seeds, traffic

SPEC = json.loads((manifest.BENCH / "traffic" / "train-coco-b32.json")
                  .read_text())["targets"]
SEEDS = (0, 7, 2 ** 31 + 5, -3)


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(seed):
    a = traffic.image_pool(seed, 2, 2, 32, "cpu")
    b = traffic.image_pool(seed, 2, 2, 32, "cpu")
    assert torch.equal(a, b)
    ta = traffic.targets(seed, 2, 4, 640, SPEC, 80)
    tb = traffic.targets(seed, 2, 4, 640, SPEC, 80)
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))
    assert torch.equal(traffic.uniforms(seed, 2, 3, "cpu"),
                       traffic.uniforms(seed, 2, 3, "cpu"))


@pytest.mark.parametrize("pair", [(0, 1), (2 ** 31 + 5, 2 ** 31 + 6),
                                  (3, -3)])
def test_two_seeds_differ(pair):
    a, b = pair
    assert not torch.equal(traffic.image_pool(a, 1, 2, 32, "cpu"),
                           traffic.image_pool(b, 1, 2, 32, "cpu"))
    assert not torch.equal(traffic.targets(a, 2, 4, 640, SPEC, 80)[1],
                           traffic.targets(b, 2, 4, 640, SPEC, 80)[1])
    assert not torch.equal(traffic.uniforms(a, 1, 2, "cpu"),
                           traffic.uniforms(b, 1, 2, "cpu"))


def test_streams_are_independent():
    assert len({seeds.stream(5, n) for n in
                ("images", "targets", "uniforms", "weights")}) == 4


def test_targets_follow_the_traffic_file():
    labels, boxes, mask = traffic.targets(11, 8, 64, 640, SPEC, 80)
    counts = mask.sum(-1)
    assert counts.min() >= 1 and counts.max() <= SPEC["max_boxes"]
    assert 5.0 < counts.float().mean() < 9.5            # COCO's ~7 a picture
    b = boxes[mask]
    assert (b[:, 2:] > 0).all() and (b[:, 2:] <= SPEC["max_side"]).all()
    assert (b[:, :2] - b[:, 2:] / 2 >= -1e-6).all()     # inside the image
    assert (b[:, :2] + b[:, 2:] / 2 <= 1 + 1e-6).all()
    side = (b[:, 2] * b[:, 3]).sqrt() * 640
    small = float((side < 32).float().mean())
    assert abs(small - SPEC["area_shares"]["small"]["share"]) < 0.03
    share0 = float((labels[mask] == 0).float().mean())
    zipf = 1.0 / (np.arange(80) + 1.0) ** SPEC["class_zipf"]
    assert abs(share0 - zipf[0] / zipf.sum()) < 0.03
    assert (boxes[~mask] == 0).all()
