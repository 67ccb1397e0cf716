"""Serving: prefill/decode steps and the continuous-batching engine."""
