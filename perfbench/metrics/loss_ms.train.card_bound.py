"""loss_ms.train.card_bound: loss_ms.train, read alike, in the training
cells whose card sets the pace (they report train_img_per_s.card_bound)."""

from perfbench.harness import manifest


def read(ctx):
    return manifest.reader("loss_ms.train").read(ctx)
