"""Data on the device: the batch augmentation (loaders come with ROADMAP A8)."""
