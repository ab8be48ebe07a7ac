"""Sensor-classification datasets (numpy; a copy of repro/data/tabular.py)."""
