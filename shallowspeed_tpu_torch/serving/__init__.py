"""Serving runtime: the paged KV cache (`cache`) and the
continuous-batching engine (`engine.ServingEngine`)."""
