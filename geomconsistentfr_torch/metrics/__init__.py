"""Evaluation metrics and the Multi-PIE protocol (numpy, on the host)."""
