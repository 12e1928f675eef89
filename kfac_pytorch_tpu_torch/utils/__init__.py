"""Utilities of the PyTorch port: the environment summary and the
metrics writer."""
