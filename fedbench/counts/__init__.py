"""Frozen operation and byte counts, and the card's peaks: the yardstick
the per-layer metrics divide by. They are computed from shapes alone, so
no change to the program can move them."""
