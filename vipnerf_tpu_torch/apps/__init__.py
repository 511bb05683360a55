"""The per-dataset entry points: train, test, score and render videos."""
