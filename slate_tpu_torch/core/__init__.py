"""Port package: core."""
