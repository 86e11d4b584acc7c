"""Batches for the port: synthetic pretraining batches (``dummy``)."""
