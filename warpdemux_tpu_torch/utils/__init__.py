"""Helpers outside the decision path: synthetic reads."""
