"""Port copies of the reference's experiment scripts."""
