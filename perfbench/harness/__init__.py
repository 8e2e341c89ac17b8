"""The general parts of the benchmark: manifest, traffic, weights,
the runs of each traffic kind, trace reading and the correctness comparison."""
