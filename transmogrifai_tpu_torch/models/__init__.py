"""Fitted predictor stages and the tree traversal kernel."""
