"""Attention ops: the plain torch reference and the paged decode kernel."""
