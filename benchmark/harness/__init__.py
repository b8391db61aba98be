"""The benchmark harness: finds a cell's configuration, traffic mix,
limits and per-layer metric readers by name, drives the program under
test through a timed window, reduces its trace, and checks its outputs
against the plain reference."""
