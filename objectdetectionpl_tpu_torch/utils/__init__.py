"""Weight carry-over and transforms, timing, metric logging, the model
summary, profiler hooks and box panels."""
