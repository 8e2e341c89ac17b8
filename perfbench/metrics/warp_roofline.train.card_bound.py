"""warp_roofline.train.card_bound: warp_roofline.train, read alike, in the training
cells whose card sets the pace (they report train_img_per_s.card_bound)."""

from perfbench.harness import manifest


def read(ctx):
    return manifest.reader("warp_roofline.train").read(ctx)
