"""Evaluation data (cameras + downsampled images)."""
