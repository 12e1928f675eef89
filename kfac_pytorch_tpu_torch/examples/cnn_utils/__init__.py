"""Data, optimizer and epoch loops of the CNN trainers."""
