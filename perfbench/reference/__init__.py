"""Frozen float32 references of what the benchmarked port computes.

Plain PyTorch; imports nothing of the port, of JAX or of the JAX
package.  A configuration file names its module under ``reference``.
"""
