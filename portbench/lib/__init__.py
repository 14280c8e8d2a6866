"""The benchmark's own machinery: finding cells by name, drawing weights and
inputs from the seed, reading the profiler's trace, counting work, and the
comparison that decides `correct`.  Imports nothing of the port at module
level; `port.py` is the one module that builds the port's objects."""
