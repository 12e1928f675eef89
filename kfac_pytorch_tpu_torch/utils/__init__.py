"""Utilities of the PyTorch port: the environment summary, the metrics
writer and the monolithic checkpoints (``utils.checkpoint``)."""
