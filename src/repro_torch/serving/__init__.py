"""Serving: slot admission and the continuous-batching scheduler."""
