"""Optimizer, schedulers, train state, and the train, eval and predict steps."""
