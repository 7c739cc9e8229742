"""Training data of the PyTorch port (the training steps are not ported yet)."""
