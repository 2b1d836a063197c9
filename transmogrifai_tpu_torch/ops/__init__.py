"""Fitted feature-engineering stages."""
