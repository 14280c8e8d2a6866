"""One module per kind of traffic.  Each has `run(ctx) -> dict` (set-up,
warm-up and the measured window; the dict is what the metric readers read)
and `check(ctx, run) -> (numbers, limits)` (the comparison that decides
`correct`, made once the window has closed)."""
