"""Experiment harness of the port: batch inference so far."""
