"""Preconditioner helpers. Only the pattern lookup that AIR needs is
ported so far; the preconditioners themselves are ROADMAP.md Queue 1
item 12."""
