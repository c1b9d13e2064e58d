"""Training engines of the port: the LM's `context` engine (one device)
and the MLP's pipeline VM, schedules and SPMD pipeline over a (dp, pp)
grid of devices (`mesh`)."""
