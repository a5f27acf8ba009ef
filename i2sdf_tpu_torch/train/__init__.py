"""Eval-render driver (chunked full-image rendering)."""
