"""Host-side utilities: trajectory metrics, consistency, checkpoints."""
