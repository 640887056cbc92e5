"""The yardstick: operation and byte counts of the work a cell's inputs
need, and the published peaks of the card. Frozen here so that a change to
the program cannot move it."""
