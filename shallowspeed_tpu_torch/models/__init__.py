"""The transformer LM, its KV-cache attention core and decode helpers."""
