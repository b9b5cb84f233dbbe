"""Keyed per-metric windows backed by one device bank."""
