"""Weight carry-over and serving-time weight transforms."""
