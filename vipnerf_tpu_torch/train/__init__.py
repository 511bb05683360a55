"""Training-side pieces the serving path needs: the checkpoint contract."""
