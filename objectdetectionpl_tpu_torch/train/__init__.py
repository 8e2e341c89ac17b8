"""Train, eval and predict steps (predict only, so far)."""
