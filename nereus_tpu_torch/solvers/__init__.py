"""Solver steps of the port."""
