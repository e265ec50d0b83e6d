"""Serving statuses and results."""
