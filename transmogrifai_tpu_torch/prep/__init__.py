"""Fitted data-preparation stages."""
