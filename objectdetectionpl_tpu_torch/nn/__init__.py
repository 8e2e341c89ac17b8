"""Torch building blocks shared by the detector families."""
