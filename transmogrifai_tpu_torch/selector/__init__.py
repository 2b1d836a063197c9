"""The model selector's fitted winner."""
