"""Measurement entry points of the PyTorch port."""
