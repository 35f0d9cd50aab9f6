"""Datasets, synthetic pools and on-device pair synthesis."""
