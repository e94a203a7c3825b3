"""Experiment harness of the port: batch inference, star-graph training
and the box-scale benchmark so far."""
