"""Offline dataset tools: videos and text to pretraining records."""
