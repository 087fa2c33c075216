"""RelightNet and its layers (PyTorch)."""
