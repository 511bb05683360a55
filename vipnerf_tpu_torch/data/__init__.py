"""Data preprocessing (test mode)."""
