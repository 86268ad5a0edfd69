"""Batch containers."""
