"""Training engines of the port: the LM's `context` engine over a (dp,
sp) grid, the GSPMD family (`gspmd` and its `tensor`, `fsdp`,
`composite` and `expert` engines over a named `mesh.Grid`), the LM
pipeline (`pipeline_lm`, its split backward `zb` and the schedule
verifier `verify`) over a (dp, pp[, tp]) `mesh.Grid`, and the MLP's
pipeline VM, schedules and SPMD pipeline over a (dp, pp) grid of
devices (`mesh`)."""
