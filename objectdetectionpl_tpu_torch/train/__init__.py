"""Optimizer, schedulers, train state, the train, eval and predict steps,
checkpoints, and the Trainer that drives them."""
