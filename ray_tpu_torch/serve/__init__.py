"""Serving of the port: the continuous-batching LLM engine."""
