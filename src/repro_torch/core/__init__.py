"""Confidence, calibration, cascade and uplink simulator."""
