"""Synthetic fixtures (numpy)."""
