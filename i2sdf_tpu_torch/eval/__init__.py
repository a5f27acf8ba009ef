"""Evaluation modes."""
