"""Model implementations of the PyTorch port."""
